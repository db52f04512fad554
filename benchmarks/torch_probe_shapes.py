#!/usr/bin/env python3
"""The port's point kernel (``src/repro_torch/csrc/probe.cu``, launched by
B2 and B7) and stacked kernels (``csrc/stacked.cu``, B5 and B6) alone on
the shapes ``chip_smoke.py`` gives them, on one NVIDIA card, for the
package under ``--src`` (default: this checkout's ``src``):

* B2 on the per-SST filter of phases 3 and 5: 2,000,000 keys at 16
  bits/key, Δ (7, 7), 1,000,000 lanes (3.8 MiB, in the L2), one chunk of
  262,144 point queries (half present) replayed;
* B7 on phase 8's grown filter: 25,000,000 keys under ``auto``, ``grow(4)``
  and 75,000,000 keys more (50,000,000 lanes, 190.7 MiB, four times the
  L2); 20 chunks of 262,144 point queries, each captured once (cold), and
  the first one replayed (hot);
* B5 and B6 on phase 6's stack: 4 rows of the phase-3 layout (4,000,000
  lanes), 262,144 range and point queries.

Each row holds the kernel's time alone (a CUDA graph, ``chip_smoke.py``'s
``_graph_ms``), its bound (the inputs as int64, a byte per verdict, and
the 32-byte sectors the verdicts need, or the whole state where most are
needed), the floor of its launch (an empty kernel of its grid, with its
shared memory or its descriptor parameter), the plain version's time and
the kernel against the plain version (``max_abs_err``, 0 is bit for bit).
To compare two trees on one card, run it in turns in one call (parent,
change, change, parent), the parent from a ``git archive`` under
``build/``::

    python3 benchmarks/torch_probe_shapes.py --src build/parent/src

It prints one JSON line, last, and imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = 4                  # chip_smoke.py phase 6's stack


def _floor(cs, device, blocks: int, rows: int = 1, smem: int = 0,
           param: bool = False) -> float:
    """The launch floor of a grid (``csrc/floor.cu``) in the package under
    test; a package whose empty kernel takes no descriptor parameter
    (before the parameter reached the probe kernels) is timed without."""
    from repro_torch.kernels import _build

    args = (blocks, rows, 256, smem)
    if len(_build._ENTRY["bloomrf_empty"][1]) == 6:
        args += (int(param),)
    return cs._graph_ms(lambda: _build.launch("bloomrf_empty", device,
                                              *args))


def _row(cs, kern, plain, nbytes, floor_ms, chunks=None) -> dict:
    """One kernel's row: ``kern(chunk)`` alone, hot on the first chunk, cold
    over all of them when there are several; the plain version on the first
    chunk."""
    chunks = chunks or [None]
    calls = [lambda c=c: kern(c) for c in chunks]
    bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
    row = {"ms": cs._graph_ms(calls if len(calls) > 1 else calls[0]),
           "plain_ms": cs._cuda_ms(lambda: plain(chunks[0]), 3),
           "bound_ms": bound, "bound_by": "bytes", "floor_ms": floor_ms,
           "floored_bound_ms": max(bound, floor_ms),
           "max_abs_err": cs._max_err(kern(chunks[0]), plain(chunks[0]))}
    if len(calls) > 1:
        row["ms_hot_replay"] = cs._graph_ms(calls[0])
    return row


def cases(device, cs) -> dict:
    """The three states and their query chunks, built once through the
    package under test."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import BloomRF, basic_layout, stacked_probe
    from repro_torch.kernels import insert_resident

    top = (1 << 32) - 1
    out = {}
    # B2: phase 5's filter and chunk
    rng = np.random.default_rng(cs.SEED + 5)
    lay = basic_layout(32, 2_000_000, 16.0, delta=7)
    keys = rng.integers(0, top + 1, 2_000_000, dtype=np.uint64)
    f = BloomRF(lay, device=device)
    state = f.insert(f.init_state(), cs._i64(keys, device))
    pq, _, _ = cs._queries(rng, cs.CHUNK, keys, top)
    out["l2"] = (lay, state, [cs._i64(pq, device)])
    # B7: phase 8's grown filter, 20 cold chunks
    rng = np.random.default_rng(cs.SEED + 8)
    keys = rng.integers(0, top + 1, cs.HBM_KEYS * cs.GROW, dtype=np.uint64)
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", n=cs.HBM_KEYS, bits_per_key=16.0))
    h.insert(keys[:cs.HBM_KEYS])
    h.grow(cs.GROW)
    h.insert(keys[cs.HBM_KEYS:])
    qrng = np.random.default_rng(cs.SEED + 89)
    out["grown"] = (h.layout, h.state, [
        cs._i64(cs._queries(qrng, cs.CHUNK, keys, top)[0], device)
        for _ in range(cs.COLD_CHUNKS)])
    # B5/B6: phase 6's stack of 4 rows, present keys in every row
    rng = np.random.default_rng(cs.SEED + 6)
    lay = basic_layout(32, 2_000_000, 16.0, delta=7)
    f = BloomRF(lay, device=device)
    stack = torch.stack([f.insert(f.init_state(), cs._i64(
        rng.integers(0, top + 1, 2_000_000, dtype=np.uint64), device))
        for _ in range(ROWS)])
    row_keys = rng.integers(0, top + 1, 1000, dtype=np.uint64)
    for r in range(ROWS):
        insert_resident(lay, stack[r], cs._i64(row_keys, device))
    pq, lo, hi = cs._queries(rng, cs.CHUNK, row_keys, top)
    lo[:5] = [0, 0, top, 9, top]
    hi[:5] = [top, 0, top, 2, 0]
    probe = stacked_probe((lay,) * ROWS,
                          tuple(r * lay.total_u32 for r in range(ROWS)),
                          device)
    out["stack"] = (lay, stack, probe, cs._i64(pq, device),
                    cs._i64(lo, device), cs._i64(hi, device))
    return out


def kernels(device, cs, built) -> dict:
    """Every kernel's row on its shape."""
    from repro_torch.core import BloomRF, stacked_probe
    from repro_torch.kernels import (_build, point_probe_partitioned,
                                     point_probe_resident,
                                     point_probe_stacked_resident,
                                     range_probe_stacked_resident)
    from repro_torch.kernels.probe import point_partitioned_plain

    param = hasattr(_build, "param_descriptor")
    grid = cs._grid(cs.CHUNK)
    out = {}
    lay, state, chunks = built["l2"]
    f = BloomRF(lay, device=device)
    smem = 0 if param else _build.device_descriptor(lay, device).numel() * 4
    out["B2_point_resident"] = _row(
        cs, lambda q: point_probe_resident(lay, state, q),
        lambda q: f.engine.point_batched(state, q),
        cs.CHUNK * 9 + lay.total_u32 * 4,
        _floor(cs, device, grid, smem=smem, param=param), chunks)
    lay, state, chunks = built["grown"]
    f = BloomRF(lay, device=device)
    sectors = sum(cs._point_read_sectors(f, state, q)
                  for q in chunks) / len(chunks)
    smem = 0 if param else _build.device_descriptor(lay, device).numel() * 4
    out["B7_point_partitioned"] = _row(
        cs, lambda q: point_probe_partitioned(lay, state, q),
        lambda q: point_partitioned_plain(lay, state, q),
        cs.CHUNK * 9 + sectors * 32,
        _floor(cs, device, grid, smem=smem, param=param), chunks)
    out["B7_point_partitioned"]["sectors"] = sectors
    lay, stack, probe, tq, tlo, thi = built["stack"]
    flat = stack.reshape(-1)
    stack_b = ROWS * lay.total_u32 * 4
    sectors = cs._range_read_sectors(probe, flat, tlo, thi)
    smem = _build.device_descriptor(lay, device).numel() * 4
    b5 = (_floor(cs, device, grid, param=True) if param
          else _floor(cs, device, grid, ROWS, smem))
    out["B5_range_stacked"] = _row(
        cs, lambda _: range_probe_stacked_resident(lay, stack, tlo, thi),
        lambda _: probe._range_all(flat, tlo, thi),
        cs.CHUNK * (16 + ROWS) + min(sectors * 32, stack_b), b5)
    out["B5_range_stacked"]["sectors"] = sectors
    # B6's cell grid with the descriptor parameter, or, in a package from
    # before the parameter reached B6 (its entry also takes the
    # descriptor's length), with the descriptor in shared memory
    old_b6 = len(_build._ENTRY["bloomrf_point_stacked"][1]) == 9
    out["B6_point_stacked"] = _row(
        cs, lambda _: point_probe_stacked_resident(lay, stack, tq),
        lambda _: probe._point_all(flat, tq),
        cs.CHUNK * (8 + ROWS) + stack_b,
        _floor(cs, device, grid, ROWS, smem if old_b6 else 0,
               param=not old_b6))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs    # puts this tree's src first on the path

    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("torch_probe_shapes: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels._build import build_all

    device = torch.device("cuda")
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "card": cs._smi(), "build_s": build_all()}
    built = cases(device, cs)
    out["kernels"] = kernels(device, cs, built)
    errs = [row["max_abs_err"] for row in out["kernels"].values()]
    print(json.dumps(out))
    return 0 if not any(errs) else 1


if __name__ == "__main__":
    sys.exit(main())
