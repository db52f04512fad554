"""The control of ``check.py``'s comparison: the reference put in the
program's place with one guarantee of the configuration broken, at the
cell's own size and inputs.  Each control has to come out not correct.

* ``lossy_build``: every build drops one key in a thousand, as an insert
  that loses some of its atomic ORs would (the guarantee: no false
  negatives, the state of every key);
* ``half_bits``: the filter at half the configuration's bits a key, a
  smaller state that would fit a faster cache (the guarantee: the layout
  and false-positive rate the spec states).

The benchmark's own runs never run it.  On the card::

    python3 -m perfbench.control --workload <name> --seeds 1 2 3

prints one JSON line a seed and control with the compared numbers.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, run, traffic

__all__ = ["CONTROLS", "control_outcome"]

CONTROLS = ("lossy_build", "half_bits")


def _lossy(keys: torch.Tensor) -> torch.Tensor:
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[::1000] = False
    return keys[keep]


def control_outcome(cell: run.Cell, seed: int, control: str,
                    device="cuda") -> check.Outcome:
    """``check.compare`` with the control's layout, state and answers in
    place of the program's, on the inputs a run of ``seed`` draws."""
    device = torch.device(device)
    gen = run.generator(seed, device)
    bits = traffic.domain_bits(cell.config)
    keys = traffic.make_keys(cell.config, cell.config["spec"]["n"], gen,
                             device)
    pool = traffic.make_pool(cell.config, cell.traffic, keys, gen, device)
    config = cell.config
    if control == "half_bits":
        spec = dict(config["spec"], bits_per_key=config["spec"][
            "bits_per_key"] / 2)
        config = dict(config, spec=spec)
    ref = check.reference(config)
    lay = ref.layout(config, bits)
    build = (lambda k: ref.build(lay, _lossy(k))) \
        if control == "lossy_build" else (lambda k: ref.build(lay, k))
    state = build(keys)
    answers = {}
    for j, b in enumerate(pool):
        if b.kind == "point":
            answers[j] = ref.point_verdicts(lay, state, b.keys)
        elif b.kind == "range":
            answers[j] = ref.range_verdicts(lay, state, b.lo, b.hi)
        else:
            answers[j] = build(b.keys)
    return check.compare(cell.config, bits, lay, keys, state, pool, answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+", default=list(CONTROLS),
                    choices=CONTROLS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = run.load_cell(args.workload)
    for seed in args.seeds:
        for c in args.controls:
            out = control_outcome(cell, seed, c)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "control": c, "correct": out.correct,
                              "failed": out.failed,
                              "numbers": {k: v for k, (v, _) in
                                          out.numbers.items()}}),
                  flush=True)
            del out
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
