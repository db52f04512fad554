#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of bloomRF (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each:

1. environment: the card (``nvidia-smi`` name and power limit) and the
   seconds it takes ``nvcc`` to build the kernels from ``src/repro_torch/csrc``;
2. each single-filter CUDA kernel against its plain PyTorch version on the
   card, bit for bit, over a sweep of layouts and the edge bounds; the
   partitioned kernels (B7/B8) also on odd batches and on layouts with
   more replicas than a range word issues at once, against plain versions
   bucketed by blocks of 256, 2048 and 16384 lanes (the kernels take no
   blocks);
3. the main path at full size: ``open_filter`` of a 2,000,000-key u32 filter
   at 16 bits/key on the default device and backend, 2,000,000 inserts,
   1,048,576 point and 1,048,576 range queries; no false negatives, the
   same verdicts as the ``backend="xla"`` twin, and exactly 8 / 4 / 4
   launches of the insert / point / range kernels and none of any other;
4. a 10,000,000-key filter (19.1 MiB of lanes) through ``backend="resident"``
   (under ``auto`` this size takes the partitioned tier), and the range
   kernel alone on it at one chunk;
5. per-kernel times at phase 3's shapes (the kernel alone, replayed from a
   CUDA graph; the plain version and the wrapper's back-to-back calls by
   CUDA events), beside each kernel's memory bound and the latency floor of
   its launch (an empty kernel with its grid, timed the same way; phases
   6-8 report both for theirs too); B1's bound counts the 32-byte sectors
   its chunk's positions touch, each read and written back once, and B1
   is also timed on phase 7's and phase 8's traffic shapes there;
6. the store-scan kernel (B4) against its plain version, ``StackedProbe.
   touch_all``, bit for bit over the run-stack classes of
   tests/test_store_scan_kernel.py (mixed Δ, several segments, replicas,
   the capacity ladder), both stack forms, quarantine masks and the edge
   bounds; the stacked kernels (B5/B6) against ``StackedProbe`` over 4 rows
   of phase 3's layout, then driven through ``FilterOps.range_stacked`` /
   ``point_stacked`` (4 launches each) and timed at 262,144 queries;
7. the LSM store at full size through ``open_filter(FilterSpec(placement=
   "store"))``: 4,194,304 uniform u32 keys loaded by ``put``, then the
   YCSB-E mix of benchmarks/store_bench.py (95% scans 256 codes wide in
   batches of 512, 5% inserts); every scan equal to a numpy oracle, every
   batch's ``(fence, touch)`` equal to the plain ``touch_all``, exactly one
   B4 launch per scan batch, one B1 launch per filter build (every flush
   and rebuild, counted by ``Store.filter_builds``), no other launch and no
   kernel fallback; the device probe plane and B4 timed per batch, B4's
   bound counting the filter sectors that the batch's range plans reach;
   B1 alone on the first flush (8,192 sorted keys) and the largest
   rebuild, as the store issues them;
8. the HBM-scale single filter: ``open_filter`` of a 25,000,000-key u32
   filter at 16 bits/key under ``auto`` (12,500,000 lanes, above the
   resident budget: the partitioned tier), 25,000,000 inserts, 1,048,576
   point and 1,048,576 range queries, then ``grow(4)`` in place (50,000,000
   lanes, 190.7 MiB), 75,000,000 more inserts and the same queries again;
   no false negatives over all 100,000,000 keys (truth sorted on the card),
   state and verdicts equal to the ``xla`` twin after each round, exactly
   8 B7, 8 B8 and 383 B1 launches and none of any other; a deletable and a
   TTL filter (4 generations) of 2,000,000 keys through
   ``backend="partitioned"`` equal to their twins; B7/B8 timed on the
   grown filter beside B2/B3 on the same filter and chunk, in turns; each
   partitioned wrapper call is one device operation under the profiler.
   B7, B8 and B1 (on the state before and after ``grow``) are timed cold:
   each of 20 input chunks is captured once in the CUDA graph, so the
   others evict its sectors from the L2 before it comes round again; the
   hot replay of one chunk rides beside it as ``ms_hot_replay``.

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


def _ptxas_usage() -> dict:
    """Registers and spill bytes of every kernel in ``src/repro_torch/csrc``
    as ``nvcc -Xptxas -v`` reports them: one cubin compile per source, all
    started together, into the build directory."""
    import re

    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-Xptxas", "-v",
         "-o", str(_build.BUILD_DIR / f"ptxas-{name}.cubin"),
         str(_build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in _build.SOURCES}
    usage = {}
    for name, proc in procs.items():
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc -Xptxas -v {name}.cu:\n{text}")
        kernel = None
        for line in text.splitlines():
            m = re.search(r"entry function '\w*?\d([a-z][a-z_]*_kernel)",
                          line)
            if m:
                kernel = m.group(1)
                usage[kernel] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and kernel:
                usage[kernel]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                usage[kernel]["registers"] = int(m.group(1))
    return usage


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


def _graph_ms(fn, reps: int = 20, replays: int = 10) -> float:
    """Device milliseconds per call of a kernel wrapper ``fn``, host dispatch
    excluded: ``reps`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events after a warm-up replay.  ``fn``
    may instead be a list of calls, each on its own input chunk, captured
    once each in order: a state larger than the L2 then finds each chunk's
    sectors evicted by the others' before the chunk comes round again
    (cold), where ``reps`` calls of one chunk would find them in the L2
    from the second call on (hot)."""
    import torch

    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * reps
    for call in dict.fromkeys(fns):   # builds and caches the descriptors
        call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in fns:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(fns) * replays)


def _floor_ms(device, blocks, threads: int, smem: int,
              rows: int = 1) -> float:
    """The latency floor of a launch: an empty kernel (``csrc/floor.cu``)
    with the grid ``(blocks, rows)``, ``threads`` per block and ``smem``
    bytes of dynamic shared memory, timed as the kernels are
    (:func:`_graph_ms`)."""
    from repro_torch.kernels import _build

    return _graph_ms(lambda: _build.launch("bloomrf_empty", device, blocks,
                                           rows, threads, smem))


def _grid(n: int, threads: int = 256) -> int:
    """Blocks of a one-thread-per-item launch (``bloomrf::grid_for``)."""
    return -(-n // threads)


def _device_busy(fn, reps: int = 4):
    """``fn``'s wall milliseconds per call (host clock, closed by a
    synchronize) beside the device time of the kernels and copies it ran
    and their count per call, from a ``torch.profiler`` trace of ``reps``
    calls (the profiler's own cost included in the wall time); None when
    the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us, ops = 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_us += e.time_range.elapsed_us()
            ops += 1
    if not dev_us:
        return None
    return {"wall_ms": wall / reps * 1e3, "device_ms": dev_us / reps / 1e3,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_ops_per_call": ops / reps}


def _pair_halves(delta, par, qlo, qhi):
    """Which words of a child pair a children_hit mask over [qlo, qhi]
    covers: (first word A, second word B), with children_hit's clamping."""
    import torch

    W = 1 << (delta - 1)
    base = par << delta
    last = base | ((1 << delta) - 1)
    o_lo = torch.minimum(torch.maximum(qlo, base), last) - base
    o_hi = torch.minimum(torch.maximum(qhi, base), last) - base
    some = o_lo <= o_hi
    return some & (o_lo < W), some & (o_hi >= W)


def _range_read_sectors(probe, flat, lo, hi, run=None) -> int:
    """Distinct 32-byte sectors of ``flat`` that a range verdict needs for
    this batch over ``probe``'s rows: per layer, the child words of each
    live path whose bits its hit mask or its covering bit can select (a
    pair shrinks to one word when the range does not cross its middle;
    before the split the right path's words are the left's), as
    ``layer_needs`` in ``csrc/partitioned.cu`` reads them; in the layer
    where a cell hits, only the one word that shows the hit.  A cell stops
    at its first hit or when both paths die.  Only the cells in ``run`` ((B,
    R) bool; all when None) run the plan.  Mirrors
    ``ProbeEngine.combine_range``, and checks its verdicts against the plain
    ``_range_all``."""
    import torch

    from repro_torch.core.bloomrf import MASK32, children_hit, lanes_u32

    lo, hi = torch.atleast_1d(lo), torch.atleast_1d(hi)
    want = probe._range_all(flat, lo, hi)
    read = []
    for e, r0, r1, base in probe.spans:
        f, lay = e.filt, e.lay
        plan = e.plan_range(probe._bounds(lo, r0, r1),
                            probe._bounds(hi, r0, r1))
        L, R = plan.L, plan.R
        lanes = plan.lanes + base
        g = lanes_u32(flat, lanes)
        alive = torch.ones_like(L, dtype=torch.bool) if run is None \
            else run[:, r0:r1].clone()
        cells = alive.clone()
        result = torch.zeros_like(alive)
        split, la, ra = result.clone(), torch.ones_like(alive), result.clone()
        if lay.top_level < lay.d:
            lt, rt = f._shr(L, lay.top_level), f._shr(R, lay.top_level)
            result = (rt - lt) >= 2
            split, ra = lt != rt, lt != rt
        alive &= ~result
        mask = torch.zeros_like(lanes, dtype=torch.bool)
        for i in reversed(range(lay.k)):
            bottom, delta = i == 0, lay.deltas[i]
            Lp, Rp = f._shr(L, lay.levels[i]), f._shr(R, lay.levels[i])
            Lpar = f._shr(L, lay.levels[i + 1])
            Rpar = f._shr(R, lay.levels[i + 1])
            edge = 0 if bottom else 1
            l_end = (Lpar << delta) | ((1 << delta) - 1)
            l_qhi = torch.where(split, l_end, (Rp - edge) & MASK32)
            l_ne = torch.ones_like(alive) if bottom else \
                torch.where(split, Lp != l_end, (Rp - Lp) >= 2)
            r_ne = torch.ones_like(alive) if bottom else Rp != (Rpar << delta)
            # the words the verdict can read (layer_needs)
            l_a, l_b = _pair_halves(delta, Lpar, (Lp + edge) & MASK32, l_qhi)
            r_a, r_b = _pair_halves(delta, Rpar, Rpar << delta,
                                    (Rp - edge) & MASK32)
            cov = lay.levels[i + 1] - 1
            b_l, b_r = (L >> cov) & 1 == 1, (R >> cov) & 1 == 1
            left, right = alive & la, alive & ra
            cov_r = alive & torch.where(split, ra, la & (Lp != Rp)) \
                & (not bottom)
            need = {
                "LA": left & ((l_ne & l_a) | (~b_l & (not bottom))),
                "LB": left & ((l_ne & l_b) | (b_l & (not bottom))),
                "RA": (right & r_ne & r_a) | (cov_r & ~b_r),
                "RB": (right & r_ne & r_b) | (cov_r & b_r),
            }
            # before the split the engine plans the one pair twice (L and R)
            same = Lpar == Rpar
            for a, b in (("LA", "RA"), ("LB", "RB")):
                both = same & (need[a] | need[b])
                need[a], need[b] = need[a] | both, need[b] | both
            slots = plan.layers[i]

            def words(need):
                m = mask.clone()
                for name, nd in need.items():
                    for sl in slots[name]:
                        for c in ((sl.col, sl.col + 1)
                                  if lay.word_bits(i) == 64 else (sl.col,)):
                            m[..., c] |= nd
                gm = torch.where(m, g, 0)
                return m, {name: e._word(gm, i, sl)
                           for name, sl in slots.items()}

            def hits(w):
                zero = tuple(torch.zeros_like(x) for x in w["LA"])
                args = {"L": (Lpar, (Lp + edge) & MASK32, l_qhi,
                              l_ne & la & alive),
                        "R": (Rpar, Rpar << delta, (Rp - edge) & MASK32,
                              r_ne & ra & alive)}
                return {p + h: children_hit(
                    delta, *args[p], *((w[p + h], zero) if h == "A"
                                       else (zero, w[p + h])))
                    for p in "LR" for h in "AB"}

            # a cell that hits in this layer needs only the one word that
            # shows its hit: the first of LA, LB, RA, RB that does
            _, w = words(need)
            witness, hit = {}, torch.zeros_like(alive)
            for name, h in hits(w).items():
                witness[name] = h & ~hit
                hit |= h
            need = {name: torch.where(hit, witness[name], nd)
                    for name, nd in need.items()}
            # the verdict from the counted words alone (the others zeroed):
            # the check below then shows that the count is enough
            mask, w = words(need)
            hit = torch.zeros_like(alive)
            for h in hits(w).values():
                hit |= h
            result |= hit
            alive &= ~hit
            if not bottom:
                covL = e._cov_bit(i, L, w["LA"], w["LB"])
                covR = e._cov_bit(i, R, w["RA"], w["RB"])
                new_split = split | (Lp != Rp)
                la, ra = la & covL, torch.where(split, ra,
                                                la & new_split) & covR
                split = new_split
                alive &= la | ra
        if not torch.equal(result & cells, want[:, r0:r1] & cells):
            raise AssertionError("range read count: verdicts != plain")
        read.append(lanes[mask])
    return int(torch.unique(torch.cat(read) >> 3).numel())


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


def _partitioned_edge_layouts():
    from repro_torch.core import FilterLayout

    return [FilterLayout(d=32, deltas=(7, 7), replicas=(3, 1),
                         seg_of_layer=(0, 0), seg_bits=(16384,)),
            FilterLayout(d=32, deltas=(4, 4, 4), replicas=(5, 1, 3),
                         seg_of_layer=(0, 0, 0), seg_bits=(16384,))]


def _check_partitioned(lay, f, state, tq, tlo, thi, kernels, errs):
    """B7 and B8 against their plain versions
    at blocks of 256, 2048 and 16384 lanes, which change only the plain
    versions (the reference's bucketing), and against the engine; swapped
    bounds too; a batch cut to an odd length as well."""
    from repro_torch.kernels import DEFAULT_TILE
    from repro_torch.kernels.probe import point_partitioned_plain
    from repro_torch.kernels.rangeprobe import range_partitioned_plain

    ppart, rpart = kernels["point_part"]["fn"], kernels["range_part"]["fn"]
    odd = tq.numel() - 37
    for q, lo, hi in ((tq, tlo, thi), (tq[:odd], tlo[:odd], thi[:odd])):
        got = ppart(lay, state, q)
        engine = f.engine.point_batched(state, q)
        errs["point_part"] = max(errs["point_part"], _max_err(got, engine))
        for blk in (256, 2048, 16384):
            errs["point_part"] = max(errs["point_part"], _max_err(
                got, point_partitioned_plain(lay, state, q, DEFAULT_TILE,
                                             blk)),
                _max_err(ppart(lay, state, q, DEFAULT_TILE, blk), got))
        if lay.has_exact:
            continue
        got = rpart(lay, state, lo, hi)
        errs["range_part"] = max(
            errs["range_part"],
            _max_err(got, f.engine.range_batched(state, lo, hi)),
            _max_err(rpart(lay, state, hi, lo), got))
        for blk in (256, 2048, 16384):
            errs["range_part"] = max(errs["range_part"], _max_err(
                got, range_partitioned_plain(lay, state, lo, hi,
                                             DEFAULT_TILE, blk)),
                _max_err(rpart(lay, state, lo, hi, DEFAULT_TILE, blk), got))


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
        _check_partitioned(lay, f, state, tq, tlo, thi, kernels, errs)
        checked += 1
    # B7/B8 with more replicas than B8 issues at once for a word (W = 64
    # and W = 8), edge bounds, odd batches
    for lay in _partitioned_edge_layouts():
        f = BloomRF(lay, device=device)
        keys = rng.integers(0, 1 << 32, 3000, dtype=np.uint64)
        pq, lo, hi = _queries(rng, 1001, keys, (1 << 32) - 1)
        lo[:7] = [0, (1 << 32) - 1, 0, (1 << 32) - 1, 9, 5, 1 << 31]
        hi[:7] = [(1 << 32) - 1, 0, 0, (1 << 32) - 1, 2, 5, (1 << 31) - 1]
        tk = _i64(keys, device)
        state = ins["fn"](lay, f.init_state(), tk)
        _check_partitioned(lay, f, state, _i64(pq, device), _i64(lo, device),
                           _i64(hi, device), kernels, errs)
    torch.cuda.synchronize()
    if any(errs.values()):
        raise AssertionError(f"kernel != plain version: max_abs_err {errs}")
    return checked


def phase_main_path(n, backend, device_name, expect_launches, kernels,
                    time_range=False):
    """Phases 3 and 4: the façade end to end, against numpy truth and the
    same spec's ``backend="xla"`` twin on the card; with ``time_range``,
    the range kernel (B3) alone on the filter at one chunk."""
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
    range_ms = None
    if time_range:
        tlo, thi = _i64(lo[:CHUNK], h.state.device), _i64(hi[:CHUNK],
                                                          h.state.device)
        range_ms = _graph_ms(lambda: kernels["range"]["fn"](
            h.layout, h.state, tlo, thi))
    return {
        "range_ms_alone": range_ms,
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


def _times(kern, plain, plain_reps: int, nbytes: int, floor_ms: float,
           call=None, cold=None) -> dict:
    """A kernel's row of the kernels line: its device time alone (CUDA
    graph), its plain version's time (CUDA events over back-to-back calls),
    the memory bound of ``nbytes`` (``bound_ms``, ``bound_by`` "bytes"),
    the latency floor of its launch (``floor_ms``, :func:`_floor_ms`) and
    the larger of the two (``floored_bound_ms``, with ``floored_bound_by``
    "bytes" or "floor"); and under ``call_ms`` the kernel wrapper's time by
    CUDA events over 200 back-to-back calls, host dispatch included
    (popped before the kernels line).  ``call`` is the wrapper call when
    ``kern`` launches the kernel alone.  With ``cold`` (the same launch on
    a list of input chunks) ``ms`` is the cold time of :func:`_graph_ms`
    over them and ``ms_hot_replay`` the hot one of ``kern``."""
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"ms": _graph_ms(cold or kern),
           "plain_ms": _cuda_ms(plain, plain_reps),
           "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
           "floor_ms": floor_ms, "floored_bound_ms": max(bound, floor_ms),
           "floored_bound_by": "bytes" if bound >= floor_ms else "floor",
           "call_ms": _cuda_ms(call or kern, 200)}
    if cold:
        row["ms_hot_replay"] = _graph_ms(kern)
    return row


COLD_CHUNKS = 20          # input chunks a cold timing rotates through


def _insert_sectors(f, keys) -> int:
    """Distinct 32-byte sectors an insert of ``keys`` touches: those of all
    their bit positions, each read once and written back once."""
    import torch

    return int(torch.unique(f.positions(keys) >> 8).numel())


def _cold_keys(device):
    """COLD_CHUNKS chunks of CHUNK fresh uniform u32 codes (int64 carriers),
    made on the card from a seed."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    keys = torch.randint(0, 1 << 32, (COLD_CHUNKS, CHUNK), generator=gen,
                         device=device, dtype=torch.int64)
    return list(keys.unbind(0))


def _b1_shape(device, fn, lay, state, chunks, plain_reps: int = 3,
              hot_too: bool = False) -> dict:
    """B1 alone on one traffic shape: ``fn(lay, state, keys)`` on a copy of
    ``state``; one chunk is replayed (hot: the state and the chunk's
    sectors stay in the L2), several are captured once each (cold, see
    :func:`_graph_ms`; with ``hot_too`` also the first chunk replayed,
    ``ms_hot_replay``).  The bound counts the bytes the insert must move,
    averaged over the chunks: its keys as int64 and every distinct sector
    its positions touch, read and written back once
    (:func:`_insert_sectors`); it is floored by an empty kernel of the
    chunk's grid.  Also the kernel against its plain version on the first
    chunk (``max_abs_err``, 0 is bit for bit)."""
    from repro_torch.core import BloomRF

    f = BloomRF(lay, device=device)
    st = state.clone()
    err = _max_err(fn(lay, state.clone(), chunks[0]),
                   f.insert(state.clone(), chunks[0]))
    n = chunks[0].numel()
    sectors = sum(_insert_sectors(f, c) for c in chunks) / len(chunks)
    nbytes = n * 8 + 2 * 32 * sectors
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    floor_ms = _floor_ms(device, _grid(n), 256, 0)
    calls = [lambda c=c: fn(lay, st, c) for c in chunks]
    row = {"keys": n, "lanes": lay.total_u32, "chunks": len(chunks),
           "ms": _graph_ms(calls if len(calls) > 1 else calls[0]),
           "plain_ms": _cuda_ms(lambda: f.insert(st, chunks[0]), plain_reps),
           "sectors": sectors, "bound_ms": bound, "bound_by": "bytes",
           "floor_ms": floor_ms, "floored_bound_ms": max(bound, floor_ms),
           "floored_bound_by": "bytes" if bound >= floor_ms else "floor",
           "max_abs_err": err}
    if hot_too:
        row["ms_hot_replay"] = _graph_ms(calls[0])
    return row


def phase_times(device, lay, kernels):
    """Phase 5: times of each kernel and its plain version at the main
    path's chunk shape, beside the memory bound."""
    import numpy as np

    from repro_torch.core import BloomRF
    from repro_torch.kernels import _build

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
    # B1-B3 launch one thread per key or range, 256 a block; B2/B3 with the
    # layout descriptor in shared memory, B1 with it in its parameters
    floor = _floor_ms(device, _grid(CHUNK), 256,
                      _build.device_descriptor(lay, device).numel() * 4)
    floors = {"insert": _floor_ms(device, _grid(CHUNK), 256, 0),
              "point": floor, "range": floor}
    sectors = _insert_sectors(f, batch)
    out = {}
    # bytes the function must move: inputs read once, outputs written once;
    # an insert reads and writes back each sector its positions touch
    for name, kern, plain, nbytes in (
            ("insert", lambda: ins(lay, state, batch),
             lambda: f.insert(state, batch), CHUNK * 8 + 64 * sectors),
            ("point", lambda: pt(lay, state, tq),
             lambda: f.engine.point_batched(state, tq),
             CHUNK * 8 + state_b + CHUNK),
            ("range", lambda: rg(lay, state, tlo, thi),
             lambda: f.engine.range_batched(state, tlo, thi),
             CHUNK * 16 + state_b + CHUNK)):
        out[name] = _times(kern, plain, 10, nbytes, floors[name])
    out["insert"]["sectors"] = sectors
    return out


# ---------------------------------------------------------------------------
# phase 6: the stacked and store-scan kernels against their plain versions
# ---------------------------------------------------------------------------

def _scan_classes():
    """The run-stack classes of tests/test_store_scan_kernel.py that the port
    builds without core/dynamic.py: name -> row layouts."""
    from repro_torch.core import FilterLayout, basic_layout

    seg = FilterLayout(d=32, deltas=(6, 5, 4), replicas=(1, 1, 1),
                       seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096))
    rep = FilterLayout(d=32, deltas=(7, 7), replicas=(1, 2),
                       seg_of_layer=(0, 0), seg_bits=(16384,))
    c0 = basic_layout(32, 400, 14.0, delta=6)
    return {
        "mixed_delta": [basic_layout(32, 500, 12.0, delta=dl)
                        for dl in (4, 6, 7)],
        "multi_segment": [seg, basic_layout(32, 400, 12.0, delta=6), seg],
        "replicas": [rep, rep, basic_layout(32, 300, 14.0, delta=7)],
        "capacity_ladder": [c0, c0, basic_layout(32, 1600, 14.0, delta=6),
                            basic_layout(32, 6400, 14.0, delta=6)],
    }


def _scan_bounds_with_edges(rng, B, kmin, kmax):
    """Scan bounds: uniform starts with widths up to 2^20, then the edges:
    0, 2^32 - 1, the whole domain, swapped bounds, lo = hi on each fence and
    ranges just off each fence."""
    import numpy as np

    top = (1 << 32) - 1
    lo = rng.integers(0, top + 1, B, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 20, B, dtype=np.uint64), top)
    edges = [(0, 0), (top, top), (0, top), (top, 0), (9, 2)]
    for a, b in zip(kmin, kmax):
        edges += [(a, a), (b, b), (b + 1, top), (0, max(a - 1, 0))]
    for i, (a, b) in enumerate(edges):
        lo[i], hi[i] = a, b
    return lo, hi


def phase_stacked_vs_plain(device, kernels, errs, big_layout):
    """Phase 6: B4 over the run-stack classes and B5/B6 over 4 rows of the
    phase-3 layout, each against its plain version on the card; then the
    stacked kernels' path (``FilterOps``) with its launches counted, and
    their times at 262,144 queries."""
    import numpy as np
    import torch

    from repro_torch.core import BloomRF, stacked_probe
    from repro_torch.kernels import (FilterOps, _build, build_run_stack,
                                     insert_resident)
    from repro_torch.kernels.store_scan import store_scan_probe_flat

    rng = np.random.default_rng(SEED + 6)
    scan, rstack, pstack = (kernels[k]["fn"] for k in
                            ("store_scan", "range_stacked", "point_stacked"))
    cells = 0
    for name, layouts in _scan_classes().items():
        states, kmin, kmax = [], [], []
        for lay in layouts:
            keys = rng.integers(0, 1 << 32, 400, dtype=np.uint64)
            f = BloomRF(lay, device=device)
            states.append(insert_resident(lay, f.init_state(),
                                          _i64(keys, device)))
            kmin.append(int(keys.min()))
            kmax.append(int(keys.max()))
        R = len(layouts)
        lo, hi = _scan_bounds_with_edges(rng, 4096, kmin, kmax)
        tlo, thi = _i64(lo, device), _i64(hi, device)
        tkmin, tkmax = _i64(kmin, device), _i64(kmax, device)
        sizes = [lay.total_u32 for lay in layouts]
        bases = tuple(int(b) for b in np.cumsum([0] + sizes[:-1]))
        flat = torch.cat(states)
        stack = build_run_stack(states)
        plain = stacked_probe(tuple(layouts), bases, device)
        for quar in (None, torch.arange(R, device=device) == 1):
            want = plain.touch_all(flat, tkmin, tkmax, tlo, thi, quar)
            got = [store_scan_probe_flat(layouts, bases, flat, tkmin, tkmax,
                                         tlo, thi, quarantine=quar)]
            got += [scan(layouts, stack, tkmin, tkmax, tlo, thi, 256, rpb,
                         quar) for rpb in (0, 2)]
            for f_k, t_k in got:
                errs["store_scan"] = max(errs["store_scan"],
                                         _max_err(f_k, want[0]),
                                         _max_err(t_k, want[1]))
                cells += f_k.numel()

    # B5/B6: 4 rows of the phase-3 layout (4,000,000 lanes: resident tier)
    lay, rows = big_layout, 4
    f = BloomRF(lay, device=device)
    stack = torch.stack([
        insert_resident(lay, f.init_state(), _i64(
            rng.integers(0, 1 << 32, 2_000_000, dtype=np.uint64), device))
        for _ in range(rows)])
    row_keys = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    for r in range(rows):                 # present keys in every row
        insert_resident(lay, stack[r], _i64(row_keys, device))
    pq, lo, hi = _queries(rng, CHUNK, row_keys, (1 << 32) - 1)
    lo[:5] = [0, 0, (1 << 32) - 1, 9, (1 << 32) - 1]
    hi[:5] = [(1 << 32) - 1, 0, (1 << 32) - 1, 2, 0]
    tq, tlo, thi = _i64(pq, device), _i64(lo, device), _i64(hi, device)
    probe = stacked_probe((lay,) * rows,
                          tuple(r * lay.total_u32 for r in range(rows)),
                          device)
    flat = stack.reshape(-1)
    errs["range_stacked"] = max(
        _max_err(rstack(lay, stack, tlo, thi), probe._range_all(flat, tlo, thi)),
        _max_err(rstack(lay, stack, thi, tlo), probe._range_all(flat, tlo, thi)))
    errs["point_stacked"] = _max_err(pstack(lay, stack, tq),
                                     probe._point_all(flat, tq))
    torch.cuda.synchronize()
    if any(errs[k] for k in ("store_scan", "range_stacked", "point_stacked")):
        raise AssertionError(f"stacked kernel != plain version: {errs}")

    # the stacked path a user calls, with its launches counted
    big_q = 4 * CHUNK
    pq4, lo4, hi4 = _queries(rng, big_q, row_keys, (1 << 32) - 1)
    tq4, tlo4, thi4 = (_i64(a, device) for a in (pq4, lo4, hi4))
    for k in kernels.values():
        k["fn"].launches = 0
    ops = FilterOps(lay)
    hits = 0
    for s in range(0, big_q, CHUNK):
        hits += int(ops.range_stacked(stack, tlo4[s:s + CHUNK],
                                      thi4[s:s + CHUNK]).sum())
        hits += int(ops.point_stacked(stack, tq4[s:s + CHUNK]).sum())
    launches = {k: v["fn"].launches for k, v in kernels.items()}
    if (launches["range_stacked"], launches["point_stacked"]) != (4, 4) \
            or sum(launches.values()) != 8:
        raise AssertionError(f"stacked path launches {launches}")

    # B5 reads the 32-byte sectors its range plans reach, B6 (most point
    # probes need most sectors at this batch) the whole stack once
    stack_b = rows * lay.total_u32 * 4
    sectors = _range_read_sectors(probe, flat, tlo, thi)
    floor = _floor_ms(device, _grid(CHUNK), 256,
                      _build.device_descriptor(lay, device).numel() * 4, rows)
    times = {}
    for name, kern, plain_fn, nbytes in (
            ("range_stacked", lambda: rstack(lay, stack, tlo, thi),
             lambda: probe._range_all(flat, tlo, thi),
             CHUNK * 16 + min(sectors * 32, stack_b) + CHUNK * rows),
            ("point_stacked", lambda: pstack(lay, stack, tq),
             lambda: probe._point_all(flat, tq),
             CHUNK * 8 + stack_b + CHUNK * rows)):
        times[name] = _times(kern, plain_fn, 5, nbytes, floor)
    return {"scan_cells_checked": cells, "stacked_rows": rows,
            "stack_lanes": rows * lay.total_u32,
            "range_sectors_read": sectors,
            "range_sector_share": sectors * 32 / stack_b,
            "path_queries": big_q,
            "path_hits": hits,
            "launches": {k: launches[k] for k in ("range_stacked",
                                                  "point_stacked")},
            "times": times}


# ---------------------------------------------------------------------------
# phase 7: the LSM store at full size (benchmarks/store_bench.py's YCSB-E)
# ---------------------------------------------------------------------------

STORE_KEYS = 1 << 22      # load-phase keys (uniform u32)
STORE_OPS = 10_000        # mixed-phase operations
SCAN_BATCH = 512          # scans per pruning batch
RSIZE = 1 << 8            # scan width in codes
NEAR_MISS = 0.2           # share of scans starting just past a stored key


def _scan_starts(n, data, rng):
    """store_bench's scan starts: uniform on [0, 2^31), or a stored key plus
    a gap in [RSIZE, 32 RSIZE) (a near miss)."""
    import numpy as np

    take_near = rng.random(n) < NEAR_MISS
    uni = rng.integers(0, 1 << 31, n, dtype=np.uint64)
    gap = rng.integers(RSIZE, 32 * RSIZE, n, dtype=np.uint64)
    anchor = data[rng.integers(0, len(data), n)]
    near = np.minimum(anchor + gap, np.uint64((1 << 32) - 1))
    return np.where(take_near, near, uni)


def _scan_ends(lo):
    import numpy as np

    return np.minimum(lo + np.uint64(RSIZE - 1), np.uint64((1 << 32) - 1))


def _record_builds(st) -> dict:
    """Watch a store's filter builds: every build's key count, and the
    ``(layout, keys)`` of the first (a level-0 flush) and of the largest."""
    rec = {"sizes": [], "flush": None, "largest": None}
    build = st._build_filter

    def recording(layout, keys):
        rec["sizes"].append(len(keys))
        if rec["flush"] is None:
            rec["flush"] = (layout, keys.copy())
        if rec["largest"] is None or len(keys) > len(rec["largest"][1]):
            rec["largest"] = (layout, keys.copy())
        return build(layout, keys)

    st._build_filter = recording
    return rec


def phase_store(device, kernels, errs):
    """Phase 7: the store end to end, against a numpy oracle and the plain
    scan plane, with B4's launches counted."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.store_scan import (SCAN_LANES, SCAN_THREADS,
                                                scan_smem_bytes,
                                                store_scan_probe_flat)

    rng = np.random.default_rng(SEED + 7)
    data = rng.integers(0, 1 << 32, STORE_KEYS, dtype=np.uint64)
    n_scans = max(int(STORE_OPS * 0.95) // SCAN_BATCH, 1) * SCAN_BATCH
    n_ins = STORE_OPS - n_scans
    lo = _scan_starts(n_scans, data, rng)
    hi = _scan_ends(lo)
    ins = rng.integers(0, 1 << 32, n_ins, dtype=np.uint64)

    for k in kernels.values():                       # counts of this run only
        k["fn"].launches = 0
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", placement="store", memtable_limit=8192, level0_runs=8,
        fanout=4, bits_per_key=14.0, delta=6))
    builds = _record_builds(h.store)
    t0 = time.perf_counter()
    for i, k in enumerate(data):
        h.put(int(k), i)
    h.flush()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results, done = [], []
    done_ins = 0
    for s in range(0, n_scans, SCAN_BATCH):
        done.append(done_ins)
        results += h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])
        owed = round(n_ins * min(s + SCAN_BATCH, n_scans) / n_scans)
        for k in ins[done_ins:owed]:
            h.put(int(k), 0)
        done_ins = owed
    t2 = time.perf_counter()
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    n_batches = n_scans // SCAN_BATCH
    st = h.store
    # one B1 launch per filter build (flush or rebuild), one B4 launch per
    # scan batch, nothing else
    want = {k: 0 for k in kernels}
    want.update(insert=st.filter_builds, store_scan=n_batches)
    if launches != want or st.filter_builds != len(builds["sizes"]) \
            or st.filter_builds != st.stats.flushes \
            + st.stats.rebuild_merges + st.stats.purge_rebuilds:
        raise AssertionError(f"store path launches {launches}, "
                             f"{st.filter_builds} filter builds, "
                             f"{n_batches} scan batches")
    if st.stats.kernel_fallbacks:
        raise AssertionError(f"{st.stats.kernel_fallbacks} kernel fallbacks")

    # every scan against the numpy oracle (last write wins; the mixed
    # phase's inserts carry value 0)
    rev = data[::-1]
    keys, first = np.unique(rev, return_index=True)
    vals = len(data) - 1 - first
    bad = 0
    for b in range(n_batches):
        extra = np.unique(ins[:done[b]])
        for j in range(b * SCAN_BATCH, (b + 1) * SCAN_BATCH):
            a = np.searchsorted(keys, lo[j], side="left")
            z = np.searchsorted(keys, hi[j], side="right")
            want = dict(zip(keys[a:z].tolist(), vals[a:z].tolist()))
            ea = np.searchsorted(extra, lo[j], side="left")
            ez = np.searchsorted(extra, hi[j], side="right")
            want.update((int(k), 0) for k in extra[ea:ez])
            bad += results[j] != sorted(want.items())
    if bad:
        raise AssertionError(f"{bad} scans differ from the oracle")

    # every batch's (fence, touch) against the plain StackedProbe.touch_all
    # (the mixed phase's inserts stayed in the memtable: one run stack)
    kmin, kmax, quar = st._device_rows()
    for s in range(0, n_scans, SCAN_BATCH):
        flo, fhi = lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH]
        fence, touch = st._touch_masks(flo, fhi)
        pf, pt = st._probe.touch_all(st._flat, kmin, kmax, _i64(flo, device),
                                     _i64(fhi, device), quar)
        errs["store_scan"] = max(
            errs["store_scan"],
            _max_err(torch.from_numpy(fence), pf.cpu()),
            _max_err(torch.from_numpy(touch), pt.cpu()))
    if errs["store_scan"]:
        raise AssertionError(f"store scan masks != plain: {errs}")

    # the device probe plane (store_bench.run_device_one): bounds encoded on
    # the card before the clock starts, sums accumulated on the card
    drng = np.random.default_rng(SEED ^ 0xDE1CE)
    dlo = _scan_starts(n_scans, data, drng)
    clo, chi = h.encode_scan_bounds(dlo, _scan_ends(dlo))
    dbytes = torch.tensor([r.data_bytes(st.cfg.value_bytes)
                           for r in st.live_runs()], device=device)

    def step(acc, s):
        f, t = h.scan_probe_device(clo[s:s + SCAN_BATCH],
                                   chi[s:s + SCAN_BATCH])
        return (acc[0] + t.sum(), acc[1] + f.sum(),
                acc[2] + (t.sum(dim=0) * dbytes).sum())

    zero = tuple(torch.zeros((), dtype=torch.int64, device=device)
                 for _ in range(3))
    step(zero, 0)
    torch.cuda.synchronize()
    acc = zero
    t3 = time.perf_counter()
    for s in range(0, n_scans, SCAN_BATCH):
        acc = step(acc, s)
    torch.cuda.synchronize()
    t4 = time.perf_counter()

    # B4 on one batch: the kernel alone, and the store's call of it
    R = len(st.live_runs())
    b_lo, b_hi = clo[:SCAN_BATCH], chi[:SCAN_BATCH]
    flat_b = st._flat.numel() * 4
    layouts = tuple(r.layout for r in st.live_runs())
    run = (b_hi[:, None] >= kmin[None, :]) & (b_lo[:, None] <= kmax[None, :])
    if quar is not None:
        run &= ~quar[None, :]
    sectors = _range_read_sectors(st._probe, st._flat, b_lo, b_hi, run)
    # bounds and fences read once, the 32-byte sectors of the flat state
    # that the fenced cells' range plans reach, two bool (B, R) outputs
    desc_words = _build.stack_descriptor(layouts, st._bases,
                                         device)[0].numel()
    floor = _floor_ms(device, _grid(SCAN_BATCH * R,
                                    SCAN_THREADS // SCAN_LANES),
                      SCAN_THREADS, scan_smem_bytes(desc_words))
    times = _times(lambda: store_scan_probe_flat(
                       layouts, st._bases, st._flat, kmin, kmax, b_lo, b_hi,
                       quar),
                   lambda: st._probe.touch_all(st._flat, kmin, kmax, b_lo,
                                               b_hi, quar), 20,
                   SCAN_BATCH * 16 + R * 16 + min(sectors * 32, flat_b)
                   + 2 * SCAN_BATCH * R, floor)
    t5 = time.perf_counter()
    for _ in range(200):
        st._kernel_scan(b_lo, b_hi)
    torch.cuda.synchronize()
    store_call_ms = (time.perf_counter() - t5) / 200 * 1e3
    # B1 on the store's build shapes: the first flush and the largest
    # rebuild, their sorted keys into a zero state, as the store issues them
    b1 = {}
    for kind in ("flush", "largest"):
        lay, keys = builds[kind]
        name = f"c_{'flush' if kind == 'flush' else 'rebuild'}_{len(keys)}"
        b1[name] = _b1_shape(device, kernels["insert"]["fn"], lay,
                             torch.zeros(lay.total_u32, dtype=torch.int32,
                                         device=device),
                             [st._codes(keys)], plain_reps=10)
        b1[name].update(deltas=lay.deltas, launches=st.filter_builds)
    stats = st.stats
    return {
        "keys": STORE_KEYS, "scans": n_scans, "inserts": n_ins,
        "runs": R, "layouts": len({r.layout for r in st.live_runs()}),
        "run_keys": [len(r) for r in st.live_runs()],
        "flat_filter_mib": flat_b / 2**20,
        "runs_probed_per_scan": stats.runs_probed_per_scan,
        "scan_fp_read_rate": stats.scan_fp_read_rate,
        "load_puts_per_s": STORE_KEYS / (t1 - t0),
        "host_scans_per_s": n_scans / (t2 - t1),
        "device_plane_us_per_scan": (t4 - t3) / n_scans * 1e6,
        "device_runs_probed_per_scan": int(acc[0]) / n_scans,
        "device_fence_pass_per_scan": int(acc[1]) / n_scans,
        "launches": launches["store_scan"], "batches": n_batches,
        "b1_launches": launches["insert"], "filter_builds": st.filter_builds,
        "flushes": stats.flushes, "rebuild_merges": stats.rebuild_merges,
        "kernel_fallbacks": stats.kernel_fallbacks,
        "b4_sectors_read": sectors, "b4_sector_share": sectors * 32 / flat_b,
        "b4_store_call_ms": store_call_ms,
        "times": times, "b1_shapes": b1,
    }


# ---------------------------------------------------------------------------
# phase 8: the HBM-scale single filter (partitioned tier), growth, deletes, TTL
# ---------------------------------------------------------------------------

HBM_KEYS = 25_000_000     # the filter's planned keys (12,500,000 lanes)
GROW = 4                  # grown in place to hold 100,000,000
MUT_KEYS = 2_000_000      # the deletable and TTL filters


def _chunks(n: int) -> int:
    return -(-n // CHUNK)


def _truth_on_card(sorted_keys, pq, lo, hi, device):
    """Point and range truth from keys sorted on the card."""
    import torch

    n = sorted_keys.numel()
    q = _i64(pq, device)
    ptruth = sorted_keys[torch.searchsorted(sorted_keys, q).clamp(
        max=n - 1)] == q
    tlo, thi = _i64(lo, device), _i64(hi, device)
    j = torch.searchsorted(sorted_keys, tlo)
    rtruth = (j < n) & (sorted_keys[j.clamp(max=n - 1)] <= thi)
    return ptruth.cpu().numpy(), rtruth.cpu().numpy()


def _point_read_sectors(f, state, keys) -> int:
    """Distinct 32-byte sectors a point probe needs: each key's positions
    in order up to its first clear bit (``point_one``'s early exit)."""
    import torch

    from repro_torch.core.bloomrf import lanes_u32

    pos = f.positions(keys)
    lane = pos >> 5
    bit = (lanes_u32(state, lane) >> (pos & 31)) & 1
    need = torch.ones_like(bit, dtype=torch.bool)
    need[:, 1:] = torch.cumprod(bit, dim=1)[:, :-1] == 1
    return int(torch.unique(lane[need] >> 3).numel())


def _mutable_twins(rng, errs):
    """A deletable and a TTL filter of MUT_KEYS keys through
    ``backend="partitioned"``, each against its ``xla`` twin: half the keys
    deleted, or four TTL windows with the first expired."""
    import numpy as np

    import repro_torch

    top = (1 << 32) - 1
    keys = rng.integers(0, top + 1, MUT_KEYS, dtype=np.uint64)
    pq, lo, hi = _queries(rng, CHUNK, keys, top)
    out = {}
    quarter = MUT_KEYS // 4
    for mut in ("deletable", "ttl"):
        kw = dict(dtype="u32", n=MUT_KEYS, bits_per_key=16.0, mutability=mut,
                  generations=4)
        h, twin = (repro_torch.open_filter(repro_torch.FilterSpec(
            backend=b, **kw)) for b in ("partitioned", "xla"))
        for x in (h, twin):
            if mut == "deletable":
                x.insert(keys)
                x.delete(keys[:MUT_KEYS // 2])
            else:
                for w in range(4):
                    x.insert(keys[w * quarter:(w + 1) * quarter])
                    x.advance_generation()
        gone, live = ((keys[:MUT_KEYS // 2], keys[MUT_KEYS // 2:])
                      if mut == "deletable" else (keys[:quarter],
                                                  keys[quarter:]))
        same = np.array_equal(h.state_numpy(), twin.state_numpy())
        if mut == "deletable":
            same &= np.array_equal(h.counts.counts, twin.counts.counts)
        else:
            same &= all(np.array_equal(a.cpu().numpy(), b.cpu().numpy())
                        for a, b in zip(h.gens.gens, twin.gens.gens))
        hp, hr = h.point(pq), h.range(lo, hi)
        tp, tr = twin.point(pq), twin.range(lo, hi)
        errs["point_part"] = max(errs["point_part"], int((hp != tp).any()))
        errs["range_part"] = max(errs["range_part"], int((hr != tr).any()))
        if not same or (hp != tp).any() or (hr != tr).any():
            raise AssertionError(f"{mut} filter differs from its xla twin")
        if h.ops.resident or not h.point(live).all():
            raise AssertionError(f"{mut} filter: false negatives or the "
                                 f"resident tier")
        out[mut] = {"lanes": h.layout.total_u32, "live_keys": len(live),
                    "gone_still_positive": float(h.point(gone).mean())}
    return out


def phase_hbm(device, kernels, errs):
    """Phase 8: the HBM-scale filter end to end with its launches counted,
    against truth on the card and the ``xla`` twin; the mutable filters;
    B7/B8 and B2/B3 timed on the grown filter."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import BloomRF, stacked_probe
    from repro_torch.kernels import DEFAULT_BLOCK_U32, DEFAULT_TILE, _build
    from repro_torch.core.bloomrf import lanes_u32
    from repro_torch.kernels.probe import (_bucket_probes, _check_tiling,
                                           _point_buckets,
                                           point_partitioned_plain)
    from repro_torch.kernels.rangeprobe import (_range_buckets,
                                                range_partitioned_plain)

    rng = np.random.default_rng(SEED + 8)
    top = (1 << 32) - 1
    n_all = HBM_KEYS * GROW
    keys = rng.integers(0, top + 1, n_all, dtype=np.uint64)
    parts = (keys[:HBM_KEYS], keys[HBM_KEYS:])
    rounds = [_queries(rng, 1 << 20, keys[:HBM_KEYS], top),
              _queries(rng, 1 << 20, keys, top)]
    kw = dict(dtype="u32", n=HBM_KEYS, bits_per_key=16.0)

    for k in kernels.values():                       # counts of this run only
        k["fn"].launches = 0
    h = repro_torch.open_filter(repro_torch.FilterSpec(**kw))
    verdicts, rates, lanes, first_state = [], [], [], None
    for r, ins in enumerate(parts):
        if r:
            first_state, first_layout = h.state.clone(), h.layout
            h.grow(GROW)
        if h.backend != "kernels" or h.ops.resident:
            raise AssertionError(f"round {r}: {h.backend}, not partitioned")
        lanes.append(h.layout.total_u32)
        pq, lo, hi = rounds[r]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h.insert(ins)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pres = h.point(pq)
        t2 = time.perf_counter()
        rres = h.range(lo, hi)
        t3 = time.perf_counter()
        verdicts.append((pres, rres))
        rates.append({"insert_keys_per_s": len(ins) / (t1 - t0),
                      "point_queries_per_s": len(pq) / (t2 - t1),
                      "range_queries_per_s": len(lo) / (t3 - t2)})
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    want = {k: 0 for k in kernels}
    want.update(insert=_chunks(len(parts[0])) + _chunks(len(parts[1])),
                point_part=2 * _chunks(1 << 20),
                range_part=2 * _chunks(1 << 20))
    if launches != want:
        raise AssertionError(f"HBM path launches {launches} != {want}")

    # truth from the keys sorted on the card, then every key probed
    kt = _i64(keys, device)
    fpr = []
    for r, n in enumerate((HBM_KEYS, n_all)):
        ptruth, rtruth = _truth_on_card(torch.sort(kt[:n]).values,
                                        *rounds[r], device)
        pres, rres = verdicts[r]
        fn_p, fn_r = int((ptruth & ~pres).sum()), int((rtruth & ~rres).sum())
        if fn_p or fn_r:
            raise AssertionError(f"round {r}: false negatives: point {fn_p}, "
                                 f"range {fn_r}")
        fpr.append({
            "point_fpr": float((pres & ~ptruth).sum() / max((~ptruth).sum(),
                                                            1)),
            "range_fpr": float((rres & ~rtruth).sum() / max((~rtruth).sum(),
                                                            1))})
    del kt
    all_present = h.point(keys)
    if not all_present.all():
        raise AssertionError(f"{int((~all_present).sum())} of {n_all} "
                             f"inserted keys probe absent")

    # the xla twin through the same steps
    twin = repro_torch.open_filter(repro_torch.FilterSpec(backend="xla",
                                                          **kw))
    for r, ins in enumerate(parts):
        if r:
            if not torch.equal(twin.state, first_state):
                raise AssertionError("round 0: state differs from the twin")
            twin.grow(GROW)
        twin.insert(ins)
        pq, lo, hi = rounds[r]
        tp, tr = twin.point(pq), twin.range(lo, hi)
        errs["point_part"] = max(errs["point_part"],
                                 int((tp != verdicts[r][0]).any()))
        errs["range_part"] = max(errs["range_part"],
                                 int((tr != verdicts[r][1]).any()))
    if not torch.equal(twin.state, h.state) or errs["point_part"] \
            or errs["range_part"]:
        raise AssertionError(f"HBM filter differs from the xla twin: {errs}")
    del twin

    mutable = _mutable_twins(rng, errs)

    # B7/B8 alone, per wrapper call and plain on the grown filter at one
    # chunk; B2/B3 on the same filter and chunk
    lay, state = h.layout, h.state
    f = BloomRF(lay, device=device)
    pq, lo, hi = _queries(np.random.default_rng(SEED + 88), CHUNK, keys, top)
    tq, tlo, thi = _i64(pq, device), _i64(lo, device), _i64(hi, device)
    desc = _build.device_descriptor(lay, device)
    pout = torch.empty(CHUNK, dtype=torch.bool, device=device)
    rout = torch.empty(CHUNK, dtype=torch.bool, device=device)

    def b7(q=tq):
        _build.launch("bloomrf_point_probe", device, q.data_ptr(),
                      CHUNK, state.data_ptr(), desc.data_ptr(), desc.numel(),
                      pout.data_ptr())

    def b8(a=tlo, b=thi):
        _build.launch("bloomrf_range_partitioned", device, a.data_ptr(),
                      b.data_ptr(), CHUNK, state.data_ptr(),
                      desc.data_ptr(), desc.numel(), rout.data_ptr())

    # cold: COLD_CHUNKS chunks drawn as the first, each captured once, so
    # the grown filter's sectors leave the L2 between a chunk's turns
    qrng = np.random.default_rng(SEED + 89)
    qcold = [tuple(_i64(a, device) for a in _queries(qrng, CHUNK, keys, top))
             for _ in range(COLD_CHUNKS)]

    ppart, rpart, pt, rg = (kernels[k]["fn"] for k in (
        "point_part", "range_part", "point", "range"))
    b7()
    b8()
    plain_p = point_partitioned_plain(lay, state, tq)
    plain_r = range_partitioned_plain(lay, state, tlo, thi)
    errs["point_part"] = max(errs["point_part"], _max_err(pout, plain_p))
    errs["range_part"] = max(errs["range_part"], _max_err(rout, plain_r))
    # bytes either function must move: keys or bounds as int64 carriers, a
    # byte per verdict, and the 32-byte sectors its probes need (a point
    # probe stops at its first clear bit; a range plan skips dead paths)
    psec = _point_read_sectors(f, state, tq)
    rsec = _range_read_sectors(stacked_probe((lay,), (0,), device), state,
                               tlo, thi)
    pbytes = CHUNK * 8 + CHUNK + psec * 32
    rbytes = CHUNK * 16 + CHUNK + rsec * 32
    # in turns, each alone from a CUDA graph: B7 beside B2 (the same
    # kernel, launched through B2's wrapper), B8 beside B3
    tiers = {}
    for turn in range(2):
        for name, kern in (
                ("point_part", b7),
                ("point_resident_B2", lambda: pt(lay, state, tq)),
                ("range_part", b8),
                ("range_resident_B3", lambda: rg(lay, state, tlo, thi))):
            tiers.setdefault(name, {}).setdefault("ms_turns", []).append(
                _graph_ms(kern))
    floor = _floor_ms(device, _grid(CHUNK), 256, desc.numel() * 4)
    times = {
        "point_part": _times(b7, lambda: point_partitioned_plain(lay, state,
                                                                 tq),
                             5, pbytes, floor,
                             call=lambda: ppart(lay, state, tq),
                             cold=[lambda c=c: b7(c[0]) for c in qcold]),
        "range_part": _times(b8, lambda: range_partitioned_plain(
            lay, state, tlo, thi), 5, rbytes, floor,
            call=lambda: rpart(lay, state, tlo, thi),
            cold=[lambda c=c: b8(c[1], c[2]) for c in qcold]),
    }
    del qcold
    # B1 alone on both states, cold (fresh chunks into copies of them)
    b1 = {}
    cold_keys = _cold_keys(device)
    for lay_b, st_b in ((first_layout, first_state), (lay, state)):
        name = f"b_hbm_{lay_b.total_u32 * 4 / 2**20:.1f}MiB"
        b1[name] = _b1_shape(device, kernels["insert"]["fn"], lay_b, st_b,
                             cold_keys, hot_too=True)
        b1[name].update(deltas=lay_b.deltas, launches=launches["insert"])
    del first_state, cold_keys
    tiers["point_resident_B2"]["call_ms"] = _cuda_ms(
        lambda: pt(lay, state, tq), 200)
    tiers["range_resident_B3"]["call_ms"] = _cuda_ms(
        lambda: rg(lay, state, tlo, thi), 200)
    for k in ("point_part", "range_part"):
        tiers[k].update(ms_cold=times[k]["ms"],
                        ms_hot_replay=times[k]["ms_hot_replay"],
                        call_ms=times[k]["call_ms"])
    tiers["point_part"]["bound_ms"] = times["point_part"]["bound_ms"]
    tiers["range_part"]["bound_ms"] = times["range_part"]["bound_ms"]
    # where the plain versions' time goes (the reference's steps, stage by
    # stage, by CUDA events over back-to-back calls), then profiler traces
    # of the wrapper calls and of one façade chunk (device busy share of
    # the wall time and device operations per call)
    eng = f.engine
    tile, blk = DEFAULT_TILE, DEFAULT_BLOCK_U32
    nblocks = _check_tiling(lay, tile, blk)
    lane_b = _point_buckets(lay, state, tq, tile, blk, nblocks)[0]
    plan, rlane_b, _, _ = _range_buckets(lay, state, tlo, thi, tile, blk,
                                         nblocks)
    flat_lanes = plan.lanes.reshape(-1)
    words = lanes_u32(state, plan.lanes)
    stages = {
        "plain_point_plan": _cuda_ms(lambda: eng.plan_point(tq), 20),
        "plain_point_plan_and_bucket": _cuda_ms(lambda: _point_buckets(
            lay, state, tq, tile, blk, nblocks), 20),
        "plain_range_plan": _cuda_ms(lambda: eng.plan_range(tlo, thi), 10),
        "plain_range_bucket": _cuda_ms(lambda: _bucket_probes(
            flat_lanes, tile, blk, nblocks), 10),
        "plain_range_combine": _cuda_ms(lambda: eng.combine_range(words,
                                                                  plan), 10),
    }
    traces = {
        "point_part_call": _device_busy(lambda: ppart(lay, state, tq)),
        "range_part_call": _device_busy(lambda: rpart(lay, state, tlo, thi)),
        "facade_point_chunk": _device_busy(lambda: h.point(pq)),
        "facade_range_chunk": _device_busy(lambda: h.range(lo, hi)),
    }
    for k in ("point_part_call", "range_part_call"):
        if traces[k] is None or traces[k]["device_ops_per_call"] != 1:
            raise AssertionError(f"{k}: {traces[k]} (one kernel expected; "
                                 f"None: the trace held no device time)")
    if errs["point_part"] or errs["range_part"]:
        raise AssertionError(f"partitioned kernel != plain: {errs}")
    return {
        "n": [HBM_KEYS, n_all], "lanes": lanes,
        "layout": {"deltas": lay.deltas, "replicas": lay.replicas},
        "launches": {k: v for k, v in launches.items() if v},
        "rounds": [{**a, **b} for a, b in zip(rates, fpr)],
        "all_keys_present": n_all, "mutable": mutable,
        "plain_chunk_probe_slots": {"point": int(lane_b.numel()),
                                    "point_real": int((lane_b >= 0).sum()),
                                    "range": int(rlane_b.numel()),
                                    "range_real": int((rlane_b >= 0).sum())},
        "point_sectors": psec, "range_sectors": rsec,
        "tiers": tiers, "call_stages_ms": stages, "traces": traces,
        "times": times, "b1_shapes": b1,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import basic_layout
    from repro_torch.kernels import (insert_resident, point_probe_partitioned,
                                     point_probe_resident,
                                     point_probe_stacked_resident,
                                     range_probe_partitioned,
                                     range_probe_resident,
                                     range_probe_stacked_resident,
                                     store_scan_probe)
    from repro_torch.kernels._build import build_all

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1/8] card: {smi} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[1/8] nvcc build of src/repro_torch/csrc: {build_all():.1f} s",
          flush=True)
    print(f"[1/8] registers and spills (nvcc -Xptxas -v): "
          f"{json.dumps(_ptxas_usage())}", flush=True)

    src, rep = "src/repro_torch/csrc/", "src/repro/kernels/"
    kernels = {
        "insert": {"fn": insert_resident, "name": "insert_resident",
                   "source": src + "insert.cu",
                   "replaces": rep + "insert.py:51"},
        "point": {"fn": point_probe_resident, "name": "point_probe_resident",
                  "source": src + "probe.cu", "replaces": rep + "probe.py:89"},
        "range": {"fn": range_probe_resident, "name": "range_probe_resident",
                  "source": src + "partitioned.cu",
                  "replaces": rep + "rangeprobe.py:67"},
        "store_scan": {"fn": store_scan_probe, "name": "store_scan_probe",
                       "source": src + "store_scan.cu",
                       "replaces": rep + "store_scan.py:126"},
        "range_stacked": {"fn": range_probe_stacked_resident,
                          "name": "range_probe_stacked_resident",
                          "source": src + "stacked.cu",
                          "replaces": rep + "rangeprobe.py:106"},
        "point_stacked": {"fn": point_probe_stacked_resident,
                          "name": "point_probe_stacked_resident",
                          "source": src + "stacked.cu",
                          "replaces": rep + "probe.py:122"},
        "point_part": {"fn": point_probe_partitioned,
                       "name": "point_probe_partitioned",
                       "source": src + "probe.cu",
                       "replaces": rep + "probe.py:170"},
        "range_part": {"fn": range_probe_partitioned,
                       "name": "range_probe_partitioned",
                       "source": src + "partitioned.cu",
                       "replaces": rep + "rangeprobe.py:155"},
    }

    def expect(**nonzero):
        return {k: nonzero.get(k, 0) for k in kernels}

    big = basic_layout(32, 2_000_000, 16.0, delta=7)
    errs = {k: 0 for k in kernels}
    t0 = time.perf_counter()
    n_lay = phase_kernels_vs_plain(device, kernels, errs, big)
    print(f"[2/8] kernel == plain on {n_lay} layouts (d 8..32, Δ 1..7, "
          f"top==d, W=64+replicas, multi-segment, exact, full size; B7/B8 "
          f"also on odd batches and replicas 3 and 5, against plain "
          f"versions bucketed at blocks of 256, "
          f"2048, 16384 lanes): max_abs_err {errs} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    main_run = phase_main_path(2_000_000, "auto", name,
                               expect(insert=8, point=4, range=4), kernels)
    if main_run["layout"]["deltas"] != big.deltas:
        raise AssertionError(f"main-path layout {main_run['layout']}")
    print(f"[3/8] main path {json.dumps(main_run)}", flush=True)
    large = phase_main_path(10_000_000, "resident", name,
                            expect(insert=39, point=4, range=4), kernels,
                            time_range=True)
    print(f"[4/8] resident 10M {json.dumps(large)}", flush=True)

    single = {k: kernels[k] for k in ("insert", "point", "range")}
    times = phase_times(device, big, single)
    print(f"[5/8] times at {CHUNK} keys/queries, filter "
          f"{big.total_u32 * 4} B, on {smi}: {json.dumps(times)}", flush=True)

    t0 = time.perf_counter()
    stacked = phase_stacked_vs_plain(device, kernels, errs, big)
    stacked_times = stacked.pop("times")
    times.update(stacked_times)
    print(f"[6/8] B4 == plain on {stacked['scan_cells_checked']} (scan, run) "
          f"cells (mixed Δ, multi-segment, replicas, capacity ladder; padded "
          f"and flat stacks, rpb 0/2, quarantine, edge bounds); B5/B6 == "
          f"plain on {stacked['stacked_rows']} rows of the phase-3 layout: "
          f"max_abs_err {errs}; {json.dumps(stacked)}; times at {CHUNK} "
          f"queries on {smi}: {json.dumps(stacked_times)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # B1 on its three traffic shapes: (a) phase 5's chunk into the phase-3
    # filter in the L2, (b) phase 8's HBM-scale states, cold, (c) the
    # store's flush and largest rebuild (phase 7)
    b1_shapes = {f"a_l2_{big.total_u32 * 4 / 2**20:.1f}MiB": {
        "keys": CHUNK, "lanes": big.total_u32, "deltas": big.deltas,
        "launches": main_run["launches"]["insert"],
        **{k: times["insert"][k] for k in (
            "ms", "plain_ms", "sectors", "bound_ms", "bound_by", "floor_ms",
            "floored_bound_ms", "floored_bound_by")}}}

    t0 = time.perf_counter()
    store = phase_store(device, kernels, errs)
    times["store_scan"] = store.pop("times")
    b1_shapes.update(store.pop("b1_shapes"))
    print(f"[7/8] store, {STORE_KEYS} keys loaded by put (the key count is "
          f"set by the host's per-key Python load path, not by the card), "
          f"YCSB-E: every scan == numpy oracle, every batch's (fence, touch) "
          f"== plain touch_all, {store['launches']} B4 launches for "
          f"{store['batches']} scan batches, {store['b1_launches']} B1 "
          f"launches for {store['filter_builds']} filter builds, no other "
          f"launch, kernel_fallbacks "
          f"{store['kernel_fallbacks']}: {json.dumps(store)}; B4 per "
          f"{SCAN_BATCH}-scan batch on {smi}: "
          f"{json.dumps(times['store_scan'])} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    hbm = phase_hbm(device, kernels, errs)
    times.update(hbm.pop("times"))
    b1_shapes.update(hbm.pop("b1_shapes"))
    print(f"[8/8] HBM-scale filter, {HBM_KEYS} keys under auto, grown x{GROW} "
          f"in place to {HBM_KEYS * GROW}: no false negatives over all keys "
          f"(truth sorted on the card), state and verdicts == xla twin, "
          f"launches {json.dumps(hbm['launches'])}; deletable and TTL "
          f"filters == their twins: {json.dumps(hbm)}; B7/B8 beside B2/B3 "
          f"on the grown filter at {CHUNK} keys/ranges on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    errs["insert"] = max([errs["insert"]] + [
        row.pop("max_abs_err", 0) for row in b1_shapes.values()])
    if errs["insert"]:
        raise AssertionError(f"B1 != plain on a traffic shape: {errs}")
    times["insert"]["shapes"] = b1_shapes
    print(f"[8/8] B1 alone on its traffic shapes ((a) the phase-3 filter in "
          f"the L2, (b) phase 8's states cold, each of {COLD_CHUNKS} chunks "
          f"captured once, (c) phase 7's flush and largest rebuild, sorted "
          f"keys) on {smi}: {json.dumps(b1_shapes)}", flush=True)

    call_ms = {k: t.pop("call_ms") for k, t in times.items()}
    print(f"[8/8] kernel wrappers' ms per call by CUDA events over 200 "
          f"back-to-back calls, host dispatch included (the kernels line's "
          f"ms is the kernel alone, from a CUDA graph): "
          f"{json.dumps(call_ms)}", flush=True)
    times["insert"]["launches_by_path"] = {
        "phase3_main": main_run["launches"]["insert"],
        "phase7_store_builds": store["b1_launches"],
        "phase8_hbm": hbm["launches"]["insert"]}
    launches = dict(main_run["launches"])
    launches.update(stacked["launches"])
    launches["store_scan"] = store["launches"]
    launches.update(point_part=hbm["launches"]["point_part"],
                    range_part=hbm["launches"]["range_part"])
    rows = [{"name": v["name"], "route": "cuda", "source": v["source"],
             "replaces": v["replaces"], "launches": launches[k],
             "max_abs_err": errs[k], **times[k]} for k, v in kernels.items()]
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
