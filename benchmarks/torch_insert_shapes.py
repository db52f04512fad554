#!/usr/bin/env python3
"""The port's insert kernel (B1, ``src/repro_torch/csrc/insert.cu``) alone on
its three traffic shapes, on one NVIDIA card, for the package under
``--src`` (default: this checkout's ``src``):

* (a) the per-SST filter of ``chip_smoke.py`` phases 3 and 5: 2,000,000 keys
  at 16 bits/key, Δ (7, 7), 1,000,000 lanes (3.8 MiB, in the L2), one
  262,144-key chunk replayed;
* (b) phase 8's HBM-scale filter: 25,000,000 keys under ``auto``
  (12,500,000 lanes, 47.7 MiB), then grown in place by ``grow(4)`` and 75,000,000
  keys more (50,000,000 lanes, 190.7 MiB); 20 chunks of 262,144 fresh
  keys, each captured once (cold), and the first one replayed (hot);
* (c) the store builds of phase 7 (``memtable_limit=8192, fanout=4,
  bits_per_key=14, delta=6``): a level-0 flush of 8,192 sorted keys (Δ (6,
  6, 6, 6), 3,584 lanes) and phase 7's largest compaction rebuild, 2,358,658
  sorted keys (Δ (6, 6), 3,670,016 lanes), each into a zero state.

Each row holds the kernel's time alone (a CUDA graph, ``chip_smoke.py``'s
``_graph_ms``), its bound (the keys as int64 and every distinct 32-byte
sector the chunk's positions touch, read and written back once), the
launch floor of its grid, the plain version's time and the kernel against
the plain version (``max_abs_err``, 0 is bit for bit).  To compare two
trees on one card, run it in turns in one call (parent, change, change,
parent), the parent from a ``git archive`` under ``build/``::

    python3 benchmarks/torch_insert_shapes.py --src build/parent/src

It prints one JSON line, last, and imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REBUILD_KEYS = 2_358_658  # chip_smoke.py phase 7's largest compaction rebuild


def _sorted_keys(rng, n: int):
    import numpy as np

    pool = np.unique(rng.integers(0, 1 << 32, n + n // 100 + 64,
                                  dtype=np.uint64))
    return np.sort(rng.choice(pool, n, replace=False))


def cases(device, cs) -> list:
    """Every shape as ``(name, layout, state, chunks, hot_too)``, built once
    through the package under test."""
    import numpy as np

    import repro_torch
    from repro_torch.core import BloomRF, basic_layout
    from repro_torch.store import Store, StoreConfig

    out = []
    # (a) phase 5's chunk: the first 262,144 of the filter's own keys
    rng = np.random.default_rng(cs.SEED + 5)
    lay = basic_layout(32, 2_000_000, 16.0, delta=7)
    keys = cs._i64(rng.integers(0, 1 << 32, 2_000_000, dtype=np.uint64),
                   device)
    f = BloomRF(lay, device=device)
    out.append(("a_l2_3.8MiB", lay, f.insert(f.init_state(), keys),
                [keys[:cs.CHUNK].contiguous()], False))
    # (b) phase 8's filter before and after grow(4), cold
    rng = np.random.default_rng(cs.SEED + 8)
    kw = dict(dtype="u32", n=cs.HBM_KEYS, bits_per_key=16.0)
    h = repro_torch.open_filter(repro_torch.FilterSpec(**kw))
    h.insert(rng.integers(0, 1 << 32, cs.HBM_KEYS, dtype=np.uint64))
    cold = cs._cold_keys(device)
    out.append(("b_hbm_47.7MiB", h.layout, h.state.clone(), cold, True))
    h.grow(cs.GROW)
    h.insert(rng.integers(0, 1 << 32, cs.HBM_KEYS * (cs.GROW - 1),
                          dtype=np.uint64))
    out.append(("b_hbm_190.7MiB", h.layout, h.state, cold, True))
    # (c) a store's flush and its largest rebuild, sorted keys, zero state
    st = Store(StoreConfig(memtable_limit=8192, level0_runs=8, fanout=4,
                           bits_per_key=14.0, delta=6), device=device)
    rng = np.random.default_rng(cs.SEED + 7)
    for name, n in (("c_flush_8192", 8192),
                    (f"c_rebuild_{REBUILD_KEYS}", REBUILD_KEYS)):
        lay = st.class_layout(n)
        out.append((name, lay, BloomRF(lay, device=device).init_state(),
                    [cs._i64(_sorted_keys(rng, n), device)], False))
    return out


def shapes(device, fn, cs, built) -> dict:
    """Every shape's row for the insert ``fn(layout, state, keys)``."""
    return {name: cs._b1_shape(device, fn, lay, state, chunks, hot_too=hot)
            for name, lay, state, chunks, hot in built}


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
        print("torch_insert_shapes: no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import insert_resident
    from repro_torch.kernels._build import build_all

    device = torch.device("cuda")
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "card": cs._smi(), "build_s": build_all()}
    built = cases(device, cs)
    out["insert_resident"] = shapes(device, insert_resident, cs, built)
    errs = [row["max_abs_err"] for row in out["insert_resident"].values()]
    print(json.dumps(out))
    return 0 if not any(errs) else 1


if __name__ == "__main__":
    sys.exit(main())
