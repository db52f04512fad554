"""The comparison that decides a run's ``correct``.

Once the window has closed, the reference (``reference/``) works out the
layout, the state and every answer again from the keys and the batches
the benchmark handed to the program, and each is compared exactly:

* ``layout_fields_differ``: fields of the layout the program chose for the
  spec (domain bits, layer distances, replicas, lanes, words per layer,
  seeds) that differ from the reference's basic layout;
* ``state_lanes_differ``: lanes of the state the program built in set-up
  that differ from the reference's build of the same keys;
* ``verdicts_differ``: point and range verdicts of the window, the last
  answer to every pool batch, that differ from the reference's;
* ``false_negatives``: of those, "no" where the sorted keys say present,
  the filter's guarantee;
* ``built_lanes_differ``: lanes of the states the window's inserts built,
  the last build of every key set, that differ from the reference's;
* ``unanswered``: pool batches the window never answered.

Every limit is 0.  The false-positive rate over the empty queries comes
out of the same pass.  The reference is the module the configuration
names under ``reference``.
"""
from __future__ import annotations

import dataclasses
import importlib
from types import ModuleType

import torch

from .reference import truth

__all__ = ["reference", "layout_fields", "Outcome", "compare"]


def reference(config: dict) -> ModuleType:
    """The reference module the configuration names under ``reference``
    (``reference/<name>.py``): ``layout(config, bits)``, ``build``,
    ``point_verdicts``, ``range_verdicts``."""
    return importlib.import_module(
        f"{__package__}.reference.{config['reference']}")


def layout_fields(lay) -> dict:
    """What identifies a hashed layout, read from the program's layout
    object or the reference's by the same attribute names."""
    return {"d": lay.d, "deltas": tuple(lay.deltas),
            "replicas": tuple(lay.replicas), "total_u32": lay.total_u32,
            "nwords": tuple(lay.nwords(i) for i in range(lay.k)),
            "seeds": tuple(int(s) for i in range(lay.k)
                           for s in lay.seeds[i][:lay.replicas[i]])}


def _lanes_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes that differ; every lane of the longer state where the two
    states differ in length."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


@dataclasses.dataclass
class Outcome:
    numbers: dict            # name -> (value, limit)
    failed: int              # pool batches answered wrongly or never
    fpr_pct: float | None    # over the empty probe queries
    ref_state: torch.Tensor  # the reference's state of the set-up keys

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.numbers.values())


def compare(config: dict, bits: int, program_layout, keys: torch.Tensor,
            program_state: torch.Tensor, pool: list,
            answers: dict) -> Outcome:
    """Hold the program's layout, set-up state and window answers
    (``answers[j]``: the last verdicts of pool batch ``j``, or the state
    its insert built) to the reference."""
    ref = reference(config)
    lay = ref.layout(config, bits)
    mine, theirs = layout_fields(lay), layout_fields(program_layout)
    n = {"layout_fields_differ": sum(mine[k] != theirs[k] for k in mine)}
    ref_state = ref.build(lay, keys)
    n["state_lanes_differ"] = _lanes_differ(program_state, ref_state)
    sorted_keys = truth.sort_keys(keys)
    kinds = {b.kind for b in pool}
    probes = kinds & {"point", "range"}
    if probes:
        n["verdicts_differ"] = n["false_negatives"] = 0
    if "insert" in kinds:
        n["built_lanes_differ"] = 0
    n["unanswered"] = 0
    failed, fp, empty = 0, 0, 0
    for j, b in enumerate(pool):
        got = answers.get(j)
        if got is None:
            n["unanswered"] += 1
            failed += 1
            continue
        if b.kind == "insert":
            bad = _lanes_differ(got, ref.build(lay, b.keys))
            n["built_lanes_differ"] += bad
            failed += bad > 0
            continue
        if b.kind == "point":
            want = ref.point_verdicts(lay, ref_state, b.keys)
            present = truth.point_truth(sorted_keys, b.keys)
        else:
            want = ref.range_verdicts(lay, ref_state, b.lo, b.hi)
            present = truth.range_truth(sorted_keys, b.lo, b.hi)
        if got.shape != want.shape:       # an answer of the wrong length
            n["verdicts_differ"] += want.numel()
            n["false_negatives"] += int(present.sum())
            failed += 1
            continue
        got = got.to(torch.bool)
        differ = int((got != want).sum())
        missed = int((present & ~got).sum())
        n["verdicts_differ"] += differ
        n["false_negatives"] += missed
        failed += (differ + missed) > 0
        fp += int((got & ~present).sum())
        empty += int((~present).sum())
    fpr = 100.0 * fp / empty if probes and empty else None
    return Outcome({k: (v, 0) for k, v in n.items()}, failed, fpr, ref_state)
