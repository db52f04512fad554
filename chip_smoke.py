#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of bloomRF (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each:

1. environment: the card (``nvidia-smi`` name and power limit) and the
   seconds it takes ``nvcc`` to build the kernels from ``src/repro_torch/csrc``;
2. each CUDA kernel against its plain PyTorch version on the card, bit for
   bit, over a sweep of layouts and the edge bounds;
3. the main path at full size: ``open_filter`` of a 2,000,000-key u32 filter
   at 16 bits/key on the default device and backend, 2,000,000 inserts,
   1,048,576 point and 1,048,576 range queries; no false negatives, the
   same verdicts as the ``backend="xla"`` twin, and exactly 8 / 4 / 4
   launches of the insert / point / range kernels;
4. a 10,000,000-key filter (19.1 MiB of lanes) through ``backend="resident"``;
5. per-kernel times with CUDA events at phase 3's shapes, beside the plain
   versions' times and each kernel's memory bound.

It prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
on any mismatch, on a kernel the main path did not launch, or when no CUDA
device is present.  It imports neither ``jax`` nor the ``repro`` package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM device-memory rate (NVIDIA data sheet), for the memory bound
HBM_BYTES_PER_S = 3.35e12
SEED = 0x5EED
CHUNK = 1 << 18


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def _i64(a, device):
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def _max_err(a, b) -> int:
    """Largest absolute difference of two int32-lane or bool tensors, read as
    unsigned values; 0 means bit for bit."""
    import torch

    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(torch.int64) & 0xFFFFFFFF
    return int((a - b).abs().max().item()) if a.numel() else 0


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _queries(rng, n_keys, keys, top):
    """Half present / half uniform point queries, and ranges with lengths
    log-uniform in 2^0..2^14 from uniform starts (mostly empty)."""
    import numpy as np

    pq = np.concatenate([rng.choice(keys, n_keys // 2),
                         rng.integers(0, top + 1, n_keys - n_keys // 2,
                                      dtype=np.uint64)])
    lo = rng.integers(0, top + 1, n_keys, dtype=np.uint64)
    length = np.floor(np.exp2(rng.uniform(0, 14, n_keys))).astype(np.uint64)
    hi = np.minimum(lo + length - np.uint64(1), np.uint64(top))
    return pq, lo, hi


def _truth(keys, pq, lo, hi):
    import numpy as np

    ks = np.sort(keys)
    pidx = np.minimum(np.searchsorted(ks, pq), len(ks) - 1)
    ptruth = ks[pidx] == pq
    idx = np.searchsorted(ks, lo)
    rtruth = (idx < len(ks)) & (ks[np.minimum(idx, len(ks) - 1)] <= hi)
    return ptruth, rtruth


def phase_kernels_vs_plain(device, kernels, errs, big_layout):
    """Phase 2: every kernel = its plain version over the layout sweep."""
    import numpy as np
    import torch

    from repro_torch.core import BloomRF, FilterLayout, basic_layout

    layouts = [basic_layout(d, 3000, 16.0, delta=dl)
               for d in (8, 16, 24, 32) for dl in range(1, 8)]
    layouts += [
        basic_layout(32, 2, 16.0),                       # top level == d
        FilterLayout(d=32, deltas=(7, 7), replicas=(1, 2), seg_of_layer=(0, 0),
                     seg_bits=(16384,)),                 # W=64 + replicas
        FilterLayout(d=32, deltas=(6, 5, 4), replicas=(2, 1, 2),
                     seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096)),
        big_layout,
    ]
    exact = FilterLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                         seg_of_layer=(2, 2, 1, 1),
                         seg_bits=(1 << 12, 4096, 8192), exact_seg=0)
    rng = np.random.default_rng(SEED)
    ins, pt, rg = (kernels[k] for k in ("insert", "point", "range"))
    checked = 0
    for lay in layouts + [exact]:
        f = BloomRF(lay, device=device)
        top = (1 << lay.d) - 1
        big = lay is big_layout
        n = 2_000_000 if big else 3000
        q = CHUNK if big else 20_000
        keys = rng.integers(0, top + 1, n, dtype=np.uint64)
        pq, lo, hi = _queries(rng, q, keys, top)
        lo[:5] = [0, 0, top, 9, top]
        hi[:5] = [top, 0, top, 2, 0]     # full domain, lo = hi, lo > hi
        tk, tq = _i64(keys, device), _i64(pq, device)
        tlo, thi = _i64(lo, device), _i64(hi, device)
        state = ins["fn"](lay, f.init_state(), tk)
        errs["insert"] = max(errs["insert"],
                             _max_err(state, f.insert(f.init_state(), tk)))
        errs["point"] = max(errs["point"], _max_err(
            pt["fn"](lay, state, tq), f.engine.point_batched(state, tq)))
        if not lay.has_exact:
            plain = f.engine.range_batched(state, tlo, thi)
            errs["range"] = max(errs["range"], _max_err(
                rg["fn"](lay, state, tlo, thi), plain),
                _max_err(rg["fn"](lay, state, thi, tlo), plain))
        checked += 1
    torch.cuda.synchronize()
    if any(errs.values()):
        raise AssertionError(f"kernel != plain version: max_abs_err {errs}")
    return checked


def phase_main_path(n, backend, device_name, expect_launches, kernels):
    """Phases 3 and 4: the façade end to end, against numpy truth and the
    same spec's ``backend="xla"`` twin on the card."""
    import numpy as np
    import torch

    import repro_torch

    kw = dict(dtype="u32", n=n, bits_per_key=16.0)
    rng = np.random.default_rng(SEED + n)
    top = (1 << 32) - 1
    keys = rng.integers(0, top + 1, n, dtype=np.uint64)
    pq, lo, hi = _queries(rng, 1 << 20, keys, top)
    ptruth, rtruth = _truth(keys, pq, lo, hi)

    for k in kernels.values():                       # counts of this run only
        k["fn"].launches = 0
    h = repro_torch.open_filter(repro_torch.FilterSpec(backend=backend, **kw))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h.insert(keys)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pres = h.point(pq)
    t2 = time.perf_counter()
    rres = h.range(lo, hi)
    t3 = time.perf_counter()
    launches = {name: k["fn"].launches for name, k in kernels.items()}

    if launches != expect_launches:
        raise AssertionError(f"launches {launches} != {expect_launches}")
    fn_p = int((ptruth & ~pres).sum())
    fn_r = int((rtruth & ~rres).sum())
    if fn_p or fn_r:
        raise AssertionError(f"false negatives: point {fn_p}, range {fn_r}")
    twin = repro_torch.open_filter(repro_torch.FilterSpec(backend="xla", **kw))
    twin.insert(keys)
    if not np.array_equal(twin.state_numpy(), h.state_numpy()):
        raise AssertionError("state differs from the xla twin")
    if not (np.array_equal(twin.point(pq), pres)
            and np.array_equal(twin.range(lo, hi), rres)):
        raise AssertionError("verdicts differ from the xla twin")
    return {
        "n": n, "backend": h.backend, "lanes": h.layout.total_u32,
        "layout": {"deltas": h.layout.deltas, "replicas": h.layout.replicas},
        "launches": launches,
        "point_fpr": float((pres & ~ptruth).sum() / max((~ptruth).sum(), 1)),
        "range_fpr": float((rres & ~rtruth).sum() / max((~rtruth).sum(), 1)),
        "insert_keys_per_s": n / (t1 - t0),
        "point_queries_per_s": len(pq) / (t2 - t1),
        "range_queries_per_s": len(lo) / (t3 - t2),
        "device": device_name,
    }


def phase_times(device, lay, kernels):
    """Phase 5: CUDA-event times of each kernel and its plain version at the
    main path's chunk shape, beside the memory bound."""
    import numpy as np

    from repro_torch.core import BloomRF

    rng = np.random.default_rng(SEED + 5)
    f = BloomRF(lay, device=device)
    keys = _i64(rng.integers(0, 1 << 32, 2_000_000, dtype=np.uint64), device)
    state = kernels["insert"]["fn"](lay, f.init_state(), keys)
    pq, lo, hi = _queries(rng, CHUNK, keys.cpu().numpy().astype(np.uint64),
                          (1 << 32) - 1)
    batch = keys[:CHUNK].contiguous()
    tq, tlo, thi = _i64(pq, device), _i64(lo, device), _i64(hi, device)
    ins, pt, rg = (kernels[k]["fn"] for k in ("insert", "point", "range"))
    state_b = lay.total_u32 * 4
    out = {}
    # bytes the function must move: inputs read once, outputs written once
    for name, kern, plain, nbytes in (
            ("insert", lambda: ins(lay, state, batch),
             lambda: f.insert(state, batch), CHUNK * 8 + 2 * state_b),
            ("point", lambda: pt(lay, state, tq),
             lambda: f.engine.point_batched(state, tq),
             CHUNK * 8 + state_b + CHUNK),
            ("range", lambda: rg(lay, state, tlo, thi),
             lambda: f.engine.range_batched(state, tlo, thi),
             CHUNK * 16 + state_b + CHUNK)):
        out[name] = {"ms": _cuda_ms(kern, 200), "plain_ms": _cuda_ms(plain, 10),
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "bound_by": "bytes", "library_ms": None}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import basic_layout
    from repro_torch.kernels import (insert_resident, point_probe_resident,
                                     range_probe_resident)
    from repro_torch.kernels._build import build_all

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/5] card: {smi} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[1/5] nvcc build of src/repro_torch/csrc: {build_all():.1f} s",
          flush=True)

    kernels = {
        "insert": {"fn": insert_resident, "source": "src/repro_torch/csrc/insert.cu",
                   "replaces": "src/repro/kernels/insert.py:51"},
        "point": {"fn": point_probe_resident,
                  "source": "src/repro_torch/csrc/probe.cu",
                  "replaces": "src/repro/kernels/probe.py:89"},
        "range": {"fn": range_probe_resident,
                  "source": "src/repro_torch/csrc/rangeprobe.cu",
                  "replaces": "src/repro/kernels/rangeprobe.py:67"},
    }
    big = basic_layout(32, 2_000_000, 16.0, delta=7)
    errs = {"insert": 0, "point": 0, "range": 0}
    t0 = time.perf_counter()
    n_lay = phase_kernels_vs_plain(device, kernels, errs, big)
    print(f"[2/5] kernel == plain on {n_lay} layouts (d 8..32, Δ 1..7, "
          f"top==d, W=64+replicas, multi-segment, exact, full size): "
          f"max_abs_err {errs} ({time.perf_counter() - t0:.1f} s)", flush=True)

    main_run = phase_main_path(2_000_000, "auto", name,
                               {"insert": 8, "point": 4, "range": 4}, kernels)
    if main_run["layout"]["deltas"] != big.deltas:
        raise AssertionError(f"main-path layout {main_run['layout']}")
    print(f"[3/5] main path {json.dumps(main_run)}", flush=True)
    large = phase_main_path(10_000_000, "resident", name,
                            {"insert": 39, "point": 4, "range": 4}, kernels)
    print(f"[4/5] resident 10M {json.dumps(large)}", flush=True)

    times = phase_times(device, big, kernels)
    print(f"[5/5] times at {CHUNK} keys/queries, filter "
          f"{big.total_u32 * 4} B, on {smi}: {json.dumps(times)}", flush=True)

    rows = [{"name": f"{k}_resident" if k == "insert" else
             f"{k}_probe_resident", "route": "cuda", "source": v["source"],
             "replaces": v["replaces"], "launches": main_run["launches"][k],
             "max_abs_err": errs[k], **times[k]} for k, v in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
