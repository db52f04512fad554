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
   its launch (an empty kernel with its grid and its shared memory or
   descriptor parameter, timed the same way; phases 6-8 report both for
   theirs too); B1's bound counts the 32-byte sectors
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
   partitioned wrapper call is one device operation under the profiler
   (counted from the trace's host-side enqueue records, each device record
   joined to its own by correlation id, and the wrapper's launch count
   over the same calls).
   B7, B8 and B1 (on the state before and after ``grow``) are timed cold:
   each of 20 input chunks is captured once in the CUDA graph, so the
   others evict its sectors from the L2 before it comes round again; the
   hot replay of one chunk rides beside it as ``ms_hot_replay``;
9. 64-bit key domains on the plain path on the card, as in the reference
   (no kernel takes a ``d > 32`` layout, and none is launched): ``mix64``
   on the card against a numpy splitmix64 finalizer on 1,000,000 keys with
   the top bit set; the default ``open_filter(FilterSpec(n=2_000_000,
   bits_per_key=16))`` (u64, keys over the whole domain) and an f64 filter
   of the same size with phase 3's query mix plus the domain's edges: no
   false negatives, 65,536 verdicts equal to the same code on the CPU and
   a state built on both equal; a d = 64 store with phase 7's settings and
   mix (4,194,304 keys, 30% of the scans starting within a scan's width of
   a stored key), every scan equal to a numpy oracle;
10. the deletable, durable store: phase 7's ``open_filter`` settings with
    ``mutability="deletable"`` and ``durability="wal"`` (a WAL in a
    temporary directory, flushed per record): 4,194,304 puts through the
    WAL, ``checkpoint()``, then 40% of the loaded keys deleted by
    ``delete_many`` in batches of 8,192 (one WAL frame each) between phase
    7's YCSB-E scan batches and inserts; every scan equal to a numpy oracle
    of the deletes, 65,536 surviving keys read their values and 65,536
    deleted keys nothing, the point FPR on 65,536 absent keys below 0.30,
    promote merges or purge rebuilds taken, one B1 launch per filter build
    and one B4 launch per scan batch and no other; then ``close()`` and
    ``Store.open`` on the card (the checkpoint plus the WAL frames after
    it) equal to the live store in durable stats, run CRCs and a scan
    batch; and the checkpoint's snapshot with flipped filter bits in its
    largest run restored on the card quarantined, its scans exact through
    B4 and ``scrub()`` reporting it;
11. obs on the main path: phase 3's filter and mix once with obs off and
    once after ``obs.enable()`` with a JSONL trace sink: 8 / 4 / 4
    launches both times and none of any other, equal verdicts and state,
    ``kernel/dispatch/resident`` equal to the calls, ``Counter.add`` of
    device tensors under ``torch.cuda.set_sync_debug_mode("error")``, and
    ``observed_fpr()`` beside the measured FPR;
12. tuner-chosen run stacks, the host baselines and the typed stores:
    (a) phase 7's store twice, ``tuning="auto"`` and ``"adaptive"``, on
    2,097,152 clustered keys (tests/test_tune.py's ``(u^4) 2^31 +
    U[0, 2^22)``): half loaded, 8 batches of 512 near-miss scans (a stored
    key + 1, 256 codes), the other half loaded, the scans again; retunes
    >= 1, a live run off the capacity ladder, scans equal between the
    twins and to a numpy oracle, one B1 launch per filter build and one B4
    launch per scan batch, B4 == plain ``touch_all`` on the final tuned
    stack over 4,096 scans with the edges, and the adaptive store's
    absent-range FPR below the static one's; (b) phase 7's store with each
    host baseline (``bloom``, ``prefix_bloom``, ``rosetta``, ``surf``) as
    ``store_backend`` at 262,144 keys (cut from phase 7's 4,194,304 by the
    numpy builds at every flush and compaction), 2,048 of phase 7's scans
    equal to the oracle (the Bloom filter answers no ranges: 2,048 gets),
    no kernel launched, beside a bloomRF store on the same stream; (c) the
    paper's standalone comparison: ``BloomRFAdapter(d=32,
    bits_per_key=16)`` on phase 3's 2,000,000 keys (8 / 1 / 1 launches,
    equal to its ``xla`` twin) against Rosetta, prefix Bloom, SuRF-lite
    and Bloom at 16 bits/key on 65,536 points and ranges, no false
    negatives, every FPR; (d) a ``str`` store of 16,384 YCSB keys
    (``user%012d``; cut from 200,000 by its read-modify-write put, a
    plain d = 64 probe on the card each) and a ``multiattr`` store of
    200,000 pairs, 1,000 scans each equal to a sorted oracle, no kernel
    launched;
13. the filter banks and the prefix cache: (a) ``open_filter`` of a
    ``placement="bank"`` u32 filter, ``n=16_000_000``, 14 bits/key, Δ 6,
    8 shards (benchmarks/dist_bench.py's settings; 2,000,000 keys a
    shard), 16,000,000 inserts in 262,144-key chunks, phase 3's points
    and ranges, 65,536 ranges across 2-3 shards and the edges: no false
    negatives, state and verdicts equal to the ``xla`` twin, one B1
    launch per row owning keys of a chunk, one B6 launch per point chunk,
    none for a range, B6 equal to the plain ``point_all``; (b) a
    ``placement="tenant"`` filter of 16 tenants x 4 shards at 1,000,000
    keys a tenant with random tenants, the same mix with and without the
    meta rows, ``meta_skip_stats``, ``grow(4)`` in place and a TTL twin
    over 4 generations, each equal to its ``xla`` twin, B1 launches for
    the main and meta rows; (c) ``PrefixCacheIndex(bits_per_key=14,
    n_tenants=16, ttl_generations=4)`` over a WAL store of phase 10's
    settings: 64 segments of 4,096 entries, 1,000 lookups (half hits),
    256 ``session_segments``, 8 ``evict_window`` sweeps,
    ``advance_generation`` and ``reopen_cold_tier``, its answers and stats
    equal to a CPU run of the same sequence, one B6 launch per lookup
    (every segment at once) and one B4 launch per sweep; (d) both sharded
    banks on an NCCL world of one equal to their banks.  B1 and B6 are
    timed alone on the bank's and the tenant bank's shapes;
14. serving a full-width ``qwen3-1.7b`` (28 layers, d_model 2048, 16
    heads, 8 KV heads, vocab 151,936; f32 parameters drawn on the card
    from a seeded generator, bf16 activations): (a) ``count_params`` ==
    the leaves' elements, in the reference's band of 1.5e9-2.7e9; (b)
    ``ServeLoop(max_seq=512, batch_slots=4, prefix_chunk=64)`` serves 8
    greedy requests, sessions 0-3 twice, prompts of 256 tokens (4
    chunks), 32 new tokens each: the first batch's 16 lookups find no
    segment and launch nothing, the second's 16 are one B6 launch each
    and all map hits, each frozen segment builds its 4 main and 4 meta
    tenant rows through B1 (16 launches), no other launch; the index's
    answers and stats == a CPU ``PrefixCacheIndex`` driven with the same
    calls; (c) the loop's greedy tokens for one request (12 tokens, 5
    new) == a manual greedy prefill and decode; (d) at full depth with
    f32 activations (TF32 off), decode of token T against the cache of
    ``prompt[:T]`` == the prefill of ``prompt[:T+1]`` within 2e-2 (B = 2,
    T = 64); (e) 2 layers at full width in f32, (a)'s weights copied to
    the CPU: prefill logits on the card == the CPU's within
    ``CARD_CPU_TOL``; (f) ``PagedKVCache`` at the full KV shape (28
    layers, 8 KV heads, hd 128, pages of 16 tokens) fed the first
    batch's prompts and decoded tokens through ``write_prefill`` and
    ``write_token``: ``gather_cache`` == the loop's cache bit for bit.
    Prefill tokens/s, decode steps/s and tokens/s and lookups/s beside
    the card;
15. the other model families at full width, f32 parameters drawn on the
    card from a seeded generator, bf16 activations, TF32 off, each model
    freed before the next: (a) ``granite-moe-3b-a800m`` (40 experts,
    top-8, capacity factor 1.25), (b) ``mamba2-130m`` and (c)
    ``zamba2-2.7b`` served as phase 14 serves qwen3 but with 16 new
    tokens: 16 B6 and 16 B1 launches each, the index == its CPU twin,
    the loop's greedy tokens for 4 prompts of 12 tokens == a manual
    greedy decode (mamba2 also at 24 = ``ssm_heads`` and 3 =
    ``conv_kernel - 1`` tokens, zamba2 at 3: the cache grow of ROADMAP
    C.7, where the SSM state and conv tails keep their shapes), f32
    decode == the longer prefill at full depth within 2e-2 (the MoE at
    the capacity factor ``n_experts / experts_per_token``, which drops
    nothing), card == CPU within ``CARD_CPU_TOL`` on 2 layers (granite:
    each token's experts compared first, logits on the sequences whose
    routing agrees), 24 (mamba2) and 6 (zamba2); the share of (token, k)
    pairs capacity drops in granite's served prefills; mamba2's
    ``ssd_chunked`` at its shapes (B 4, S 256) == the naive recurrence
    within 1e-4; (d) ``whisper-base`` (not served: the loop passes no
    frames): 4 sequences of 1,500 frame embeddings, a prefill of 64
    tokens, 16 greedy decode steps, decode == prefill in f32, card ==
    CPU at full depth; (e) ``moonshot-v1-16b-a3b`` at full width cut to
    4 of 48 layers (28.06 B f32 params need 112 GB): decode == prefill
    at the no-drop capacity.  Each part's parameters, init seconds, peak
    memory, and the served parts' rates and profiles beside the card;
16. training (the port of ``repro.train``): (a) full-width
    ``qwen3-1.7b`` (f32 parameters drawn on the card, bf16 activations,
    remat on) trained 8 steps by ``Trainer`` on
    examples/train_lm_dedup.py's stream (``SyntheticCorpus(seed=1,
    dup_rate=0.3)``, ``StreamDeduper(1 << 14)``, freshness window
    ``(0, 10000)``) at batch 4 x 512 tokens, 2 microbatches, int8 error
    feedback, AdamW at lr 3e-4 (warmup 2, 8 steps): losses and grad norms
    finite, lr == ``cosine_lr``, every leaf moved, the deduper's stats and
    every batch's tokens == a CPU twin of the stream, B1 (a shard index
    filter, a deduper insert), B2 (a deduper probe) and B3 (a window
    query) launched as the data path implies; the median step ms,
    tokens/s, one step's device busy share and operations
    (``torch.profiler``) and ``max_memory_allocated``; (b) 6 steps on one
    repeated batch (1 microbatch, no compression): the last loss below the
    first; (c) at the reference tests' sizes in f32, TF32 off, attention
    at the true fan-in (ROADMAP C.8, C.9): one train step of qwen3,
    granite-moe (2 microbatches, error feedback), zamba2 and whisper smoke
    on the card == the CPU (loss, grad norm and the step's gradient within
    1e-4 of scale, params within 1e-4 where the gradient is resolved), the
    rmsnorm and flash Functions' outputs and gradients on the card == the
    CPU within 1e-5, and the flash backward at qwen3-1.7b's heads (B 1, S
    2048, 8 KV heads, G 2, hd 128) in bf16 within 2e-2 of f32 autograd of
    the plain forward; (d) tests/test_train.py's restart test on the card
    (qwen2.5-3b smoke, 14 steps, a checkpoint every 7, a failure at step
    10 under ``Supervisor``): one restart, the final loss == the straight
    run's within 1e-4, one B1 launch per shard filter of each checkpoint,
    and ``restore_layer_range`` of layer 1 equal to that layer of the full
    restore, one B3 launch per hashed shard filter;
17. sharding (the port of ``repro.dist.sharding`` / ``pipeline`` and
    ``repro.launch``): (a) on an NCCL world of one (``file://`` init in a
    temporary directory) and a 1 x 1 ``DeviceMesh`` ("data", "model"),
    full-width ``moonshot-v1-16b-a3b`` cut to 4 of 48 layers, its params
    placed by ``make_shardings`` under ``activation_mesh``: every MoE
    layer takes the expert-parallel dispatch, and its prefill logits and
    a decode step equal the same model's without the mesh (local
    dispatch) within 2e-2 of scale in bf16 with equal greedy tokens, each
    path's step ms beside the other; (b) ``launch/cost.py`` on phase 16's
    exact step (full-width qwen3-1.7b, 4 x 512, 2 microbatches, error
    feedback) on meta tensors: its FLOPs within 0.9-1.1 of phase 16's
    shape count, its roofline terms beside phase 16's step ms and device
    ms; ``elastic_restore(..., shardings=)`` of a checkpoint onto the
    1 x 1 mesh gives the same leaves bit for bit; (c) in a subprocess
    started with the phase (CPU only, meta tensors, fake process groups
    of 256 and 512 ranks): ``python -m repro_torch.launch.dryrun --smoke``
    over qwen3, mamba2 and moonshot x train_4k, decode_32k x both meshes,
    every record ``ok``, then full-width qwen3-1.7b x train_4k x single,
    its ``argument_bytes`` == the local-shard bytes its spec tree
    implies.  No bloomRF kernel is launched.

It prints the kernels' JSON line, the card line, and last
``{"ok": true, "device": {...}}``.  It exits non-zero, printing no result,
on any mismatch, on a kernel the main path did not launch, or when no CUDA
device is present.  It imports neither ``jax`` nor the ``repro`` package.
"""
from __future__ import annotations

import contextlib
import functools
import json
import shutil
import subprocess
import sys
import tempfile
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


def _counted(kernels):
    """Zero every launch count; returns a reader of the counts since."""
    for k in kernels.values():
        k["fn"].launches = 0
    return lambda: {name: k["fn"].launches for name, k in kernels.items()}


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


def _floor_ms(device, blocks, threads: int, smem: int, rows: int = 1,
              param: bool = False) -> float:
    """The latency floor of a launch: an empty kernel (``csrc/floor.cu``)
    with the grid ``(blocks, rows)``, ``threads`` per block, ``smem``
    bytes of dynamic shared memory and, with ``param``, the descriptor
    launch parameter, timed as the kernels are (:func:`_graph_ms`)."""
    from repro_torch.kernels import _build

    return _graph_ms(lambda: _build.launch("bloomrf_empty", device, blocks,
                                           rows, threads, smem, int(param)))


def _grid(n: int, threads: int = 256) -> int:
    """Blocks of a one-thread-per-item launch (``bloomrf::grid_for``)."""
    return -(-n // threads)


#: host-side records of the calls that put work on a device: kernel
#: launches, copies and sets (``cuda*`` and ``cu*`` API calls)
_ENQUEUE = r"^cu(da)?(Launch|Memcpy|Memset)"


#: device kernels that are matrix products (cuBLAS / CUTLASS names)
_MATMUL = r"gemm|xmma|cutlass|nvjet|cublas"


def _device_busy(fn, reps: int = 4, launches=None, top: int = 0):
    """``fn``'s wall milliseconds per call (host clock, closed by a
    synchronize) beside the device time of the kernels and copies it ran
    and their count per call, from a ``torch.profiler`` trace of ``reps``
    calls (the profiler's own cost included in the wall time); None when
    the trace holds no device time.

    The operations are counted from the trace's host-side records of the
    calls that enqueue device work (CUPTI's API callbacks, taken in the
    calling thread as each call returns), plus any device record that joins
    none of them by correlation id.  A device record is delivered later,
    from CUPTI's activity buffers, and can be missing from a trace whose
    enqueue record is there (PERF.md §7): it is counted in
    ``device_records_missing`` and its time is not in ``device_ms``.
    ``launches`` (a wrapper's own launch count) must move by exactly
    ``reps`` over the traced calls.  With ``top``, also the matrix
    products' share of the device time and the ``top`` device names by
    their milliseconds per call."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = launches() if launches else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if launches and launches() - before != reps:
        raise AssertionError(f"{launches() - before} launches counted over "
                             f"{reps} traced calls")
    raw = prof.profiler.kineto_results.events()
    enqueued = {e.correlation_id() for e in raw
                if e.device_type() == DeviceType.CPU
                and re.match(_ENQUEUE, e.name())}
    device = [e for e in raw if e.device_type() != DeviceType.CPU]
    dev_us = sum(e.end_ns() - e.start_ns() for e in device) / 1e3
    joined = {e.correlation_id() for e in device} & enqueued
    orphans = sum(e.correlation_id() not in enqueued for e in device)
    if not dev_us:
        return None
    out = {"wall_ms": wall / reps * 1e3, "device_ms": dev_us / reps / 1e3,
           "device_busy_share": dev_us / 1e6 / wall,
           "device_ops_per_call": (len(enqueued) + orphans) / reps,
           "device_records": len(device),
           "device_records_missing": len(enqueued - joined)}
    if top:
        by_name: dict = {}
        for e in device:
            by_name[e.name()] = by_name.get(e.name(), 0) + (
                e.end_ns() - e.start_ns())
        mm = sum(v for k, v in by_name.items()
                 if re.search(_MATMUL, k, re.IGNORECASE))
        out["matmul_share_of_device"] = mm / 1e3 / dev_us
        out["top_device_ms"] = {k[:80]: v / 1e6 / reps for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]}
    return out


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
    log-uniform in 2^0..2^14 from uniform starts (mostly empty), clipped at
    ``top`` (up to 2^64 - 1)."""
    import numpy as np

    pq = np.concatenate([rng.choice(keys, n_keys // 2),
                         rng.integers(0, top, n_keys - n_keys // 2,
                                      dtype=np.uint64, endpoint=True)])
    lo = rng.integers(0, top, n_keys, dtype=np.uint64, endpoint=True)
    span = np.floor(np.exp2(rng.uniform(0, 14, n_keys))).astype(np.uint64) \
        - np.uint64(1)
    hi = np.where(lo > np.uint64(top) - span, np.uint64(top), lo + span)
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

    read = _counted(kernels)                         # counts of this run only
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
    launches = read()

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
    floor_ms = _floor_ms(device, _grid(n), 256, 0, param=True)
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
    # B1-B3 launch one thread per key or range, 256 a block; B1/B2 with the
    # layout descriptor in their parameters, B3 with it in shared memory
    param = _floor_ms(device, _grid(CHUNK), 256, 0, param=True)
    floors = {"insert": param, "point": param,
              "range": _floor_ms(device, _grid(CHUNK), 256, _build.
                                 device_descriptor(lay, device).numel() * 4)}
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
    from repro_torch.kernels import FilterOps, build_run_stack, insert_resident
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
    read = _counted(kernels)
    ops = FilterOps(lay)
    hits = 0
    for s in range(0, big_q, CHUNK):
        hits += int(ops.range_stacked(stack, tlo4[s:s + CHUNK],
                                      thi4[s:s + CHUNK]).sum())
        hits += int(ops.point_stacked(stack, tq4[s:s + CHUNK]).sum())
    launches = read()
    if (launches["range_stacked"], launches["point_stacked"]) != (4, 4) \
            or sum(launches.values()) != 8:
        raise AssertionError(f"stacked path launches {launches}")

    # B5 reads the 32-byte sectors its range plans reach, B6 (most point
    # probes need most sectors at this batch) the whole stack once
    stack_b = rows * lay.total_u32 * 4
    sectors = _range_read_sectors(probe, flat, tlo, thi)
    # B5: a thread a query over every row; B6: a thread a (query, row)
    # cell; both with the descriptor in the launch's parameters
    floors = {"range_stacked": _floor_ms(device, _grid(CHUNK), 256, 0,
                                         param=True),
              "point_stacked": _floor_ms(device, _grid(CHUNK), 256, 0, rows,
                                         param=True)}
    times = {}
    for name, kern, plain_fn, nbytes in (
            ("range_stacked", lambda: rstack(lay, stack, tlo, thi),
             lambda: probe._range_all(flat, tlo, thi),
             CHUNK * 16 + min(sectors * 32, stack_b) + CHUNK * rows),
            ("point_stacked", lambda: pstack(lay, stack, tq),
             lambda: probe._point_all(flat, tq),
             CHUNK * 8 + stack_b + CHUNK * rows)):
        times[name] = _times(kern, plain_fn, 5, nbytes, floors[name])
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
STORE7 = dict(memtable_limit=8192, level0_runs=8, fanout=4,
              bits_per_key=14.0, delta=6)    # the store's settings
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


def _ycsb_e(h, data, lo, hi, ins):
    """The store's load (``put`` of every key of ``data``, value its index,
    then a flush) and YCSB-E mix (the scans in batches of SCAN_BATCH, the
    inserts, value 0, spread between them); returns the scan results, each
    batch's count of inserts before it, and the load and mix seconds."""
    import torch

    t0 = time.perf_counter()
    for i, k in enumerate(data):
        h.put(int(k), i)
    h.flush()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results, done = [], []
    done_ins = 0
    for s in range(0, len(lo), SCAN_BATCH):
        done.append(done_ins)
        results += h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])
        owed = round(len(ins) * min(s + SCAN_BATCH, len(lo)) / len(lo))
        for k in ins[done_ins:owed]:
            h.put(int(k), 0)
        done_ins = owed
    return results, done, t1 - t0, time.perf_counter() - t1


def _scan_mismatches(data, ins, lo, hi, done, results) -> int:
    """Scans that differ from a numpy oracle of the store's contents when
    each batch ran (last write wins; the mixed phase's inserts carry value
    0)."""
    import numpy as np

    rev = data[::-1]
    keys, first = np.unique(rev, return_index=True)
    vals = len(data) - 1 - first
    bad = 0
    for b in range(len(done)):
        extra = np.unique(ins[:done[b]])
        for j in range(b * SCAN_BATCH, min((b + 1) * SCAN_BATCH, len(lo))):
            a = np.searchsorted(keys, lo[j], side="left")
            z = np.searchsorted(keys, hi[j], side="right")
            want = dict(zip(keys[a:z].tolist(), vals[a:z].tolist()))
            ea = np.searchsorted(extra, lo[j], side="left")
            ez = np.searchsorted(extra, hi[j], side="right")
            want.update((int(k), 0) for k in extra[ea:ez])
            bad += results[j] != sorted(want.items())
    return bad


def _record_builds(st, keep=None) -> dict:
    """Watch a store's filter builds: every build's key count, the
    ``(layout, keys)`` of the first (a level-0 flush) and of the largest,
    and under ``"kept"`` the ``(layout, keys, state)`` of every build for
    which ``keep(layout, keys)`` holds."""
    rec = {"sizes": [], "flush": None, "largest": None, "kept": []}
    build = st._build_filter

    def recording(layout, keys):
        rec["sizes"].append(len(keys))
        if rec["flush"] is None:
            rec["flush"] = (layout, keys.copy())
        if rec["largest"] is None or len(keys) > len(rec["largest"][1]):
            rec["largest"] = (layout, keys.copy())
        state = build(layout, keys)
        if keep is not None and keep(layout, keys):
            rec["kept"].append((layout, keys.copy(), state.clone()))
        return state

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

    read = _counted(kernels)                         # counts of this run only
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", placement="store", **STORE7))
    builds = _record_builds(h.store)
    results, done, load_s, mix_s = _ycsb_e(h, data, lo, hi, ins)
    launches = read()
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

    bad = _scan_mismatches(data, ins, lo, hi, done, results)
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
        "load_puts_per_s": STORE_KEYS / load_s,
        "host_scans_per_s": n_scans / mix_s,
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
    in order up to its first clear bit (``rangeplan::point_verdict``'s early
    exit)."""
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

    read = _counted(kernels)                         # counts of this run only
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
    launches = read()
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
    pdesc = _build.param_descriptor(lay)
    pout = torch.empty(CHUNK, dtype=torch.bool, device=device)
    rout = torch.empty(CHUNK, dtype=torch.bool, device=device)

    def b7(q=tq):
        _build.launch("bloomrf_point_probe", device, q.data_ptr(),
                      CHUNK, state.data_ptr(), pdesc.ctypes.data,
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
                             5, pbytes, _floor_ms(device, _grid(CHUNK), 256,
                                                  0, param=True),
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
        "point_part_call": _device_busy(lambda: ppart(lay, state, tq),
                                        launches=lambda: ppart.launches),
        "range_part_call": _device_busy(lambda: rpart(lay, state, tlo, thi),
                                        launches=lambda: rpart.launches),
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


# ---------------------------------------------------------------------------
# phase 9: 64-bit key domains (the plain path on the card)
# ---------------------------------------------------------------------------

WIDE_KEYS = 2_000_000     # the u64 and f64 filters (phase 3's size)
WIDE_STORE_KEYS = STORE_KEYS  # the d = 64 store's load, phase 7's
SUBSAMPLE = 1 << 16       # queries answered again on the CPU
MIX64_KEYS = 1_000_000


def _mix64_np(x):
    """The splitmix64 finalizer in numpy uint64 (multiplies wrap)."""
    import numpy as np

    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _wide_filter(dtype, keys, pq, lo, hi, codes):
    """One 64-bit single filter through the default ``open_filter`` (the
    plain engine on the card): inserted in chunks, then probed; zero false
    negatives against numpy truth on the codes; a subsample's verdicts
    equal to the same code on the CPU holding the card's state; a filter of
    the subsample's keys built on both devices to the same state."""
    import numpy as np

    import repro_torch

    spec = repro_torch.FilterSpec(dtype=dtype, n=WIDE_KEYS, bits_per_key=16.0)
    h = repro_torch.open_filter(spec)
    if h.backend != "xla" or h.codec.d != 64:
        raise AssertionError(f"{dtype}: backend {h.backend}, d {h.codec.d}")
    t0 = time.perf_counter()
    h.insert(keys)
    t1 = time.perf_counter()
    pres = h.point(pq)
    t2 = time.perf_counter()
    rres = h.range(lo, hi)
    t3 = time.perf_counter()
    rates = {"insert_keys_per_s": len(keys) / (t1 - t0),
             "point_queries_per_s": len(pq) / (t2 - t1),
             "range_queries_per_s": len(lo) / (t3 - t2)}
    if h.state.device.type != "cuda":
        raise AssertionError(f"{dtype}: state on {h.state.device}")
    clo, chi = codes(lo), codes(hi)          # a swapped range is its swap
    ptruth, rtruth = _truth(codes(keys), codes(pq), np.minimum(clo, chi),
                            np.maximum(clo, chi))
    fn_p, fn_r = int((ptruth & ~pres).sum()), int((rtruth & ~rres).sum())
    if fn_p or fn_r:
        raise AssertionError(f"{dtype}: false negatives: point {fn_p}, "
                             f"range {fn_r}")
    host = repro_torch.open_filter(spec, device="cpu")
    host.load_state(h.state_numpy())
    sub = slice(0, SUBSAMPLE // 2), slice(len(pq) - SUBSAMPLE // 2, None)
    qs = np.concatenate([pq[sub[0]], pq[sub[1]]])
    if not (np.array_equal(host.point(qs), h.point(qs))
            and np.array_equal(host.range(lo[:SUBSAMPLE], hi[:SUBSAMPLE]),
                               rres[:SUBSAMPLE])):
        raise AssertionError(f"{dtype}: verdicts differ from the CPU")
    small = [repro_torch.open_filter(spec, device=d) for d in (None, "cpu")]
    for x in small:
        x.insert(keys[:SUBSAMPLE])
    if not np.array_equal(small[0].state_numpy(), small[1].state_numpy()):
        raise AssertionError(f"{dtype}: state differs from the CPU's")
    return {"lanes": h.layout.total_u32,
            "layout": {"deltas": h.layout.deltas,
                       "replicas": h.layout.replicas},
            "point_fpr": float((pres & ~ptruth).sum()
                               / max((~ptruth).sum(), 1)),
            "range_fpr": float((rres & ~rtruth).sum()
                               / max((~rtruth).sum(), 1)),
            **rates}


def phase_wide(device, kernels):
    """Phase 9: 64-bit key domains, on the plain path on the card as in
    the reference (no kernel takes a d > 32 layout): ``mix64`` on the card
    against numpy; the default ``open_filter`` (u64) and an f64 filter of
    2,000,000 keys; a d = 64 LSM store under phase 7's YCSB-E settings.
    No kernel launches."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import codecs, hashing, uint64

    read = _counted(kernels)
    rng = np.random.default_rng(SEED + 9)
    top = (1 << 64) - 1
    x = rng.integers(0, 1 << 63, MIX64_KEYS, dtype=np.uint64) \
        | np.uint64(1 << 63)
    got = hashing.mix64(uint64.carrier(x, device)).cpu().numpy()
    if not np.array_equal(got.view(np.uint64), _mix64_np(x)):
        raise AssertionError("mix64 on the card != numpy's")

    out = {}
    # (a) the default spec: u64 keys over the whole domain
    keys = rng.integers(0, top, WIDE_KEYS, dtype=np.uint64, endpoint=True)
    pq, lo, hi = _queries(rng, 1 << 20, keys, top)
    edges = [(0, top), (0, 0), (top, top), (top - 9, top), (top, 0),
             ((1 << 63) - 5, (1 << 63) + 5), (1 << 63, (1 << 63) - 1)]
    lo[-len(edges):] = [a for a, _ in edges]
    hi[-len(edges):] = [b for _, b in edges]
    out["u64"] = _wide_filter("u64", keys, pq, lo, hi,
                              lambda a: np.asarray(a, np.uint64))
    # (b) f64 keys, with both zeros
    fkeys = np.concatenate([[-0.0, 0.0], rng.normal(0, 1e6, WIDE_KEYS - 2)])
    fq = np.concatenate([rng.choice(fkeys, 1 << 19),
                         rng.normal(0, 1e6, 1 << 19)])
    flo = rng.normal(0, 1e6, 1 << 20)
    fhi = flo + np.exp2(rng.uniform(-10, 4, 1 << 20))
    out["f64"] = _wide_filter("f64", fkeys, fq, flo, fhi,
                              codecs.float64_to_u64)

    # (c) the d = 64 store: phase 7's settings and mix, 64-bit keys
    data = rng.integers(0, top, WIDE_STORE_KEYS, dtype=np.uint64,
                        endpoint=True)
    n_scans = max(int(STORE_OPS * 0.95) // SCAN_BATCH, 1) * SCAN_BATCH
    n_ins = STORE_OPS - n_scans
    slo = rng.integers(0, top - RSIZE, n_scans, dtype=np.uint64,
                       endpoint=True)
    # 30% start within a scan's width of a stored key: hits and near misses
    near = rng.random(n_scans) < 0.3
    anchor = np.clip(data[rng.integers(0, len(data), near.sum())],
                     np.uint64(RSIZE), np.uint64(top - 3 * RSIZE))
    slo[near] = anchor + rng.integers(0, 2 * RSIZE, near.sum(),
                                      dtype=np.uint64) - np.uint64(RSIZE)
    shi = slo + np.uint64(RSIZE - 1)
    ins = rng.integers(0, top, n_ins, dtype=np.uint64, endpoint=True)
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u64", placement="store", **STORE7))
    results, done, load_s, mix_s = _ycsb_e(h, data, slo, shi, ins)
    st = h.store
    bad = _scan_mismatches(data, ins, slo, shi, done, results)
    if bad:
        raise AssertionError(f"d = 64 store: {bad} scans differ from the "
                             f"oracle")
    if st._scan_kernel_mode() != "xla" or any(
            r.state.device.type != "cuda" for r in st.live_runs()):
        raise AssertionError("d = 64 store: not the plain path on the card")
    launches = read()
    if any(launches.values()):
        raise AssertionError(f"64-bit phase launched kernels: {launches}")
    torch.cuda.synchronize()
    out["store"] = {
        "keys": WIDE_STORE_KEYS, "scans": n_scans, "inserts": n_ins,
        "runs": len(st.live_runs()), "filter_builds": st.filter_builds,
        "rebuild_merges": st.stats.rebuild_merges,
        "or_merges": st.stats.or_merges,
        "nonempty_scans": sum(1 for r in results if r),
        "runs_probed_per_scan": st.stats.runs_probed_per_scan,
        "scan_fp_read_rate": st.stats.scan_fp_read_rate,
        "load_puts_per_s": WIDE_STORE_KEYS / load_s,
        "host_scans_per_s": n_scans / mix_s}
    out["mix64_keys_checked"] = MIX64_KEYS
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 10: the deletable, durable store (phase 7's settings, WAL, deletes)
# ---------------------------------------------------------------------------

DEL_FRAC = 0.4            # share of the loaded keys deleted
DEL_BATCH = 8192          # keys per delete_many (one WAL frame each)
GET_SAMPLE = 1 << 16      # surviving, deleted and absent keys looked up


class _Oracle:
    """The phase-10 store's contents as numpy: the loaded keys (sorted,
    each with the index of its last put as value) with an alive mask, and
    the keys put after the load (value 0), applied in the store's order."""

    def __init__(self, data):
        import numpy as np

        rev = data[::-1]
        self.keys, first = np.unique(rev, return_index=True)
        self.vals = len(data) - 1 - first
        self.alive = np.ones(len(self.keys), bool)
        self.extra = {}

    def delete(self, keys):
        import numpy as np

        self.alive[np.searchsorted(self.keys, keys)] = False
        for k in keys.tolist():
            self.extra.pop(k, None)

    def put(self, keys):
        self.extra.update((int(k), 0) for k in keys)

    def scans(self, lo, hi) -> list:
        import numpy as np

        ek = np.asarray(sorted(self.extra), np.uint64)
        out = []
        for a_, b_ in zip(lo, hi):
            a = np.searchsorted(self.keys, a_, side="left")
            z = np.searchsorted(self.keys, b_, side="right")
            live = self.alive[a:z]
            want = dict(zip(self.keys[a:z][live].tolist(),
                            self.vals[a:z][live].tolist()))
            ea = np.searchsorted(ek, a_, side="left")
            ez = np.searchsorted(ek, b_, side="right")
            want.update((int(k), 0) for k in ek[ea:ez])
            out.append(sorted(want.items()))
        return out


CHURN_OPS = 20_000        # the churn store's ops (40% deletes)


def _churn(kernels) -> dict:
    """Phase 10's churn: the mix of the reference's churn contract
    (tests/test_store_churn.py: 40% of the ops delete the oldest live key)
    on a small deletable u32 store (memtable 128, level0_runs 2, fanout 4)
    with a flush every 20 ops, so compaction meets sparse and dead-heavy
    runs: promote merges and purge rebuilds both run on the card.  Every
    live key reads its value, the point FPR on absent keys stays below
    0.30, one B1 launch per build, one B4 launch per scan batch."""
    import numpy as np

    import repro_torch

    read = _counted(kernels)
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", placement="store", memtable_limit=128, level0_runs=2,
        fanout=4, bits_per_key=14.0, delta=6, mutability="deletable"))
    rng = np.random.default_rng(SEED + 100)
    model = {}
    for i in range(CHURN_OPS):
        if model and rng.random() < 0.4:
            k = next(iter(model))
            h.delete(k)
            del model[k]
        else:
            k = int(rng.integers(0, 1 << 32))
            h.put(k, i)
            model.pop(k, None)
            model[k] = i
        if i % 20 == 19:
            h.flush()
    live = np.fromiter(model, np.uint64, len(model))
    if h.get_many(live) != [model[int(k)] for k in live]:
        raise AssertionError("churn: a live key lost its value")
    srt = np.sort(live)
    lo = np.concatenate([live[:SCAN_BATCH // 2] - np.uint64(3),
                         rng.integers(0, 1 << 32, SCAN_BATCH // 2,
                                      dtype=np.uint64)])
    hi = np.minimum(lo + np.uint64(1 << 16), np.uint64((1 << 32) - 1))
    want = [[(int(k), model[int(k)]) for k in
             srt[np.searchsorted(srt, a):np.searchsorted(srt, b, "right")]]
            for a, b in zip(lo, hi)]
    if h.scan_many(lo, hi) != want:
        raise AssertionError("churn: scans differ from the model")
    absent = rng.integers(0, 1 << 32, GET_SAMPLE, dtype=np.uint64)
    absent = absent[~np.isin(absent, live)]
    fence, filt = h.store.probe_runs(absent, absent, point=True)
    fpr = float((fence & filt).any(axis=1).mean())
    st, stats = h.store, h.stats
    launches = read()
    want_l = {k: 0 for k in kernels}
    want_l.update(insert=st.filter_builds, store_scan=1)
    if stats.promote_merges == 0 or stats.purge_rebuilds == 0 \
            or launches != want_l or not fpr < 0.30:
        raise AssertionError(f"churn: launches {launches}, "
                             f"{st.filter_builds} builds, stats "
                             f"{stats.as_dict()}, point FPR {fpr}")
    return {"ops": CHURN_OPS, "live_keys": len(live),
            "promote_merges": stats.promote_merges,
            "purge_rebuilds": stats.purge_rebuilds,
            "or_merges": stats.or_merges,
            "rebuild_merges": stats.rebuild_merges,
            "b1_launches": launches["insert"],
            "filter_builds": st.filter_builds,
            "b4_launches": launches["store_scan"], "point_fpr_absent": fpr}


def phase_durable(device, kernels, wal_dir):
    """Phase 10: ``open_filter`` of phase 7's store with
    ``mutability="deletable"`` and ``durability="wal"``: 4,194,304 puts
    through the WAL, a checkpoint, 40% of the loaded keys deleted in
    ``delete_many`` batches of 8,192 between the YCSB-E scan batches and
    inserts; every scan against a numpy oracle of the deletes, gets of
    surviving and deleted keys, the point FPR on absent keys, B1 launches
    == filter builds and B4 launches == scan batches; then recovery by
    ``Store.open`` on the card against the live store, and a snapshot with
    flipped filter bits restored quarantined, scanned exactly through
    B4 and found by ``scrub``.  At these settings no merge's dead fraction
    passes ``purge_dead_frac`` and no promote passes the density guard
    (tombstones meet their targets only in the bottom merge, and the
    level-0 merges' sources are full), so the promote and purge branches
    run in :func:`_churn`, where they are asserted."""
    import os
    import pickle

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.store import FaultPlan, Store
    from repro_torch.store.faults import flip_filter_bits

    rng = np.random.default_rng(SEED + 10)
    data = rng.integers(0, 1 << 32, STORE_KEYS, dtype=np.uint64)
    n_scans = max(int(STORE_OPS * 0.95) // SCAN_BATCH, 1) * SCAN_BATCH
    n_ins = STORE_OPS - n_scans
    lo = _scan_starts(n_scans, data, rng)
    hi = _scan_ends(lo)
    ins = rng.integers(0, 1 << 32, n_ins, dtype=np.uint64)
    uniq = np.unique(data)
    dels = rng.permutation(uniq)[: int(len(uniq) * DEL_FRAC)]
    n_del_batches = -(-len(dels) // DEL_BATCH)
    n_batches = n_scans // SCAN_BATCH

    read = _counted(kernels)                         # counts of this run only
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", placement="store", mutability="deletable",
        durability="wal", wal_dir=wal_dir, **STORE7))
    st = h.store
    t0 = time.perf_counter()
    for i, k in enumerate(data):
        h.put(int(k), i)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ckpt = h.checkpoint()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ckpt_bytes = os.path.getsize(ckpt)
    frames0 = st.stats.wal_appends

    # the mix: each scan batch after its share of the delete batches, the
    # inserts after each batch; the events replay on the oracle below
    events, results = [], []
    del_s = scan_s = 0.0
    done_del = done_ins = 0
    for b in range(n_batches + 1):
        owed = round(n_del_batches * b / n_batches)
        if done_del < owed:
            t = time.perf_counter()
            for j in range(done_del, owed):
                batch = dels[j * DEL_BATCH:(j + 1) * DEL_BATCH]
                h.delete_many(batch)
                events.append(("del", batch))
            del_s += time.perf_counter() - t
            done_del = owed
        if b == n_batches:
            break
        s = b * SCAN_BATCH
        t = time.perf_counter()
        results.append(h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH]))
        scan_s += time.perf_counter() - t
        events.append(("scan", b))
        owed = round(n_ins * (b + 1) / n_batches)
        for k in ins[done_ins:owed]:
            h.put(int(k), 0)
        events.append(("put", ins[done_ins:owed]))
        done_ins = owed
    torch.cuda.synchronize()
    frames = st.stats.wal_appends - frames0

    oracle = _Oracle(data)
    bad = 0
    for ev in events:
        if ev[0] == "del":
            oracle.delete(ev[1])
        elif ev[0] == "put":
            oracle.put(ev[1])
        else:
            s = ev[1] * SCAN_BATCH
            bad += sum(a != b for a, b in zip(
                results[ev[1]], oracle.scans(lo[s:s + SCAN_BATCH],
                                             hi[s:s + SCAN_BATCH])))
    if bad:
        raise AssertionError(f"{bad} scans differ from the oracle after "
                             f"the deletes")

    # gets: surviving keys read their values, deleted keys read nothing
    put_late = np.asarray(sorted(oracle.extra), np.uint64)
    surv = np.flatnonzero(oracle.alive & ~np.isin(oracle.keys, put_late))
    pick = rng.choice(surv, GET_SAMPLE, replace=False)
    gone = np.setdiff1d(dels, put_late)
    gone = rng.choice(gone, GET_SAMPLE, replace=False)
    t = time.perf_counter()
    got = h.get_many(oracle.keys[pick])
    get_s = time.perf_counter() - t
    if got != oracle.vals[pick].tolist():
        raise AssertionError("a surviving key lost its value")
    if any(v is not None for v in h.get_many(gone)):
        raise AssertionError("a deleted key still reads a value")
    # point FPR on keys never put, and on the deleted keys
    absent = rng.integers(0, 1 << 32, 2 * GET_SAMPLE, dtype=np.uint64)
    absent = absent[~np.isin(absent, uniq) & ~np.isin(absent, ins)]
    absent = absent[:GET_SAMPLE]
    fpr = {}
    for name, keys in (("absent", absent), ("deleted", gone)):
        fence, filt = st.probe_runs(keys, keys, point=True)
        fpr[name] = float((fence & filt).any(axis=1).mean())
    if not fpr["absent"] < 0.30:
        raise AssertionError(f"point FPR after deletes {fpr}")
    stats = st.stats

    launches = read()
    want = {k: 0 for k in kernels}
    want.update(insert=st.filter_builds, store_scan=n_batches)
    if launches != want or st.filter_builds != stats.flushes \
            + stats.rebuild_merges + stats.purge_rebuilds:
        raise AssertionError(f"durable store launches {launches}, "
                             f"{st.filter_builds} filter builds, "
                             f"{n_batches} scan batches")
    if stats.kernel_fallbacks:
        raise AssertionError(f"{stats.kernel_fallbacks} kernel fallbacks")

    # recovery: the checkpoint plus the WAL frames written after it
    h.close()
    t = time.perf_counter()
    rec = Store.open(wal_dir, device="cuda")
    torch.cuda.synchronize()
    open_s = time.perf_counter() - t
    if rec.stats.wal_replayed != frames:
        raise AssertionError(f"replayed {rec.stats.wal_replayed} frames of "
                             f"{frames}")
    if rec.stats.durable_snapshot() != stats.durable_snapshot():
        raise AssertionError(f"durable stats {rec.stats.durable_snapshot()} "
                             f"!= {stats.durable_snapshot()}")
    if [r.checksums() for r in rec.live_runs()] != \
            [r.checksums() for r in st.live_runs()] \
            or any(r.state.device.type != device.type
                   for r in rec.live_runs()):
        raise AssertionError("recovered runs differ from the live store's")
    fixed = slice(0, SCAN_BATCH)
    if rec.scan_many(lo[fixed], hi[fixed]) != st.scan_many(lo[fixed],
                                                           hi[fixed]):
        raise AssertionError("recovered store scans differ from the live")

    # quarantine: the checkpoint's snapshot with flipped filter bits in its
    # largest run, restored on the card; scans stay exact through B4
    with open(ckpt, "rb") as f:
        snap = pickle.loads(f.read())
    lvl, idx = max(((i, j) for i, lv in enumerate(snap["levels"])
                    for j in range(len(lv))),
                   key=lambda ij: snap["levels"][ij[0]][ij[1]]["n"])
    snap["levels"][lvl][idx] = flip_filter_bits(
        snap["levels"][lvl][idx], FaultPlan(seed=SEED).rng, nbits=3)
    q = Store.restore(snap, device="cuda")
    if len(q.quarantined_runs()) != 1:
        raise AssertionError(f"{len(q.quarantined_runs())} runs quarantined")
    at_ckpt = _Oracle(data)
    n0 = kernels["store_scan"]["fn"].launches
    qbad = 0
    for s in range(0, 4 * SCAN_BATCH, SCAN_BATCH):
        qbad += sum(a != b for a, b in zip(
            q.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH]),
            at_ckpt.scans(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])))
    qi = [i for i, r in enumerate(q.live_runs()) if r.quarantined][0]
    fence, touch = q.scan_probe_device(_i64(lo[fixed], device),
                                       _i64(hi[fixed], device))
    q_launches = kernels["store_scan"]["fn"].launches - n0
    if qbad or q_launches != 5 or q.stats.kernel_fallbacks \
            or not bool((touch[:, qi] == fence[:, qi]).all()) \
            or q.stats.degraded_probes == 0:
        raise AssertionError(f"quarantined store: {qbad} scans differ, "
                             f"{q_launches} B4 launches")
    scrub = q.scrub()
    if scrub["quarantined"] != 1:
        raise AssertionError(f"scrub {scrub}")
    rec.close()
    churn = _churn(kernels)
    return {
        "churn": churn,
        "keys": STORE_KEYS, "deleted": int(len(dels)),
        "delete_batches": n_del_batches, "scans": n_scans,
        "inserts": n_ins, "runs": len(st.live_runs()),
        "run_keys": [len(r) for r in st.live_runs()],
        "launches": launches["store_scan"], "batches": n_batches,
        "b1_launches": launches["insert"], "filter_builds": st.filter_builds,
        "flushes": stats.flushes, "or_merges": stats.or_merges,
        "rebuild_merges": stats.rebuild_merges,
        "promote_merges": stats.promote_merges,
        "purge_rebuilds": stats.purge_rebuilds,
        "kernel_fallbacks": stats.kernel_fallbacks,
        "point_fpr_absent": fpr["absent"], "point_fpr_deleted": fpr["deleted"],
        "runs_probed_per_scan": stats.runs_probed_per_scan,
        "wal_frames_after_checkpoint": frames,
        "wal_replayed": rec.stats.wal_replayed,
        "load_puts_per_s_wal": STORE_KEYS / (t1 - t0),
        "deletes_per_s": len(dels) / del_s,
        "host_scans_per_s": n_scans / scan_s,
        "gets_per_s": GET_SAMPLE / get_s,
        "checkpoint_s": t2 - t1, "checkpoint_bytes": ckpt_bytes,
        "open_replay_s": open_s,
        "quarantine": {"run_keys": len(q.quarantined_runs()[0]),
                       "scans_checked": 4 * SCAN_BATCH,
                       "b4_launches": q_launches,
                       "degraded_probes": q.stats.degraded_probes,
                       "scrub": scrub},
    }


# ---------------------------------------------------------------------------
# phase 11: obs on the main path
# ---------------------------------------------------------------------------

def _main_mix(h, keys, pq, lo, hi, kernels) -> dict:
    """Phase 3's inserts, points and ranges through ``h``: verdicts, the
    state, launches and rates."""
    import torch

    read = _counted(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h.insert(keys)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pres = h.point(pq)
    t2 = time.perf_counter()
    rres = h.range(lo, hi)
    t3 = time.perf_counter()
    return {"launches": read(),
            "verdicts": (pres, rres), "state": h.state_numpy(),
            "insert_keys_per_s": len(keys) / (t1 - t0),
            "point_queries_per_s": len(pq) / (t2 - t1),
            "range_queries_per_s": len(lo) / (t3 - t2)}


OBS_KEYS = 2_000_000       # phase 3's filter
OBS_QUERIES = 1 << 20      # phase 3's points and ranges


def phase_obs(device, kernels, expect_launches, trace_path):
    """Phase 11: phase 3's filter and query mix once with obs off and once
    after ``obs.enable()`` with a JSONL trace sink: the same launches (8 /
    4 / 4), verdicts and state; ``kernel/dispatch/resident`` counts equal
    the calls; ``Counter.add`` of device tensors under
    ``torch.cuda.set_sync_debug_mode("error")``; ``observed_fpr()`` beside
    the measured FPR."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch import obs

    n = OBS_KEYS
    kw = dict(dtype="u32", n=n, bits_per_key=16.0)
    rng = np.random.default_rng(SEED + n)            # phase 3's inputs
    top = (1 << 32) - 1
    keys = rng.integers(0, top + 1, n, dtype=np.uint64)
    pq, lo, hi = _queries(rng, OBS_QUERIES, keys, top)
    ptruth, rtruth = _truth(keys, pq, lo, hi)

    # warm-up: the first span of a process starts the profiler's
    # record_function machinery and NVTX; it is timed here, not below
    t0 = time.perf_counter()
    obs.enable()
    warm = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", n=4096, bits_per_key=16.0))
    warm.insert(keys[:4096])
    warm.point(pq[:4096])
    warm.range(lo[:4096], hi[:4096])
    torch.cuda.synchronize()
    obs.disable()
    first_span_s = time.perf_counter() - t0
    off = _main_mix(repro_torch.open_filter(repro_torch.FilterSpec(**kw)),
                    keys, pq, lo, hi, kernels)
    obs.registry().reset()
    obs.enable()
    obs.set_trace_sink(trace_path)
    try:
        h = repro_torch.open_filter(repro_torch.FilterSpec(**kw))
        on = _main_mix(h, keys, pq, lo, hi, kernels)
        counter = obs.registry().counter("smoke/nonzero_lanes")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:                      # stashes on the card: no synchronisation
            for _ in range(8):
                counter.add(torch.count_nonzero(h.state))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        snap = obs.export_snapshot()["metrics"]
        obs.set_trace_sink(None)
        ofpr = h.observed_fpr()       # re-probes launch: after the counts
    finally:
        obs.set_trace_sink(None)
        obs.disable()
    for name, run in (("off", off), ("on", on)):
        if run["launches"] != expect_launches:
            raise AssertionError(f"obs {name}: launches {run['launches']}")
    if not (np.array_equal(off["state"], on["state"])
            and all(np.array_equal(a, b) for a, b in zip(off["verdicts"],
                                                         on["verdicts"]))):
        raise AssertionError("verdicts or state differ with obs on")
    calls = sum(expect_launches.values())
    if snap.get("kernel/dispatch/resident") != calls:
        raise AssertionError(f"dispatch counter {snap} != {calls} calls")
    if snap["smoke/nonzero_lanes"] != 8 * np.count_nonzero(on["state"]):
        raise AssertionError("device counter settled wrong")
    with open(trace_path) as f:
        spans = [json.loads(line)["span"] for line in f]
    pres, rres = on["verdicts"]
    rate = ("insert_keys_per_s", "point_queries_per_s",
            "range_queries_per_s")
    return {
        "launches_on": on["launches"],
        "dispatch_resident": snap["kernel/dispatch/resident"],
        "spans": {s: spans.count(s) for s in sorted(set(spans))},
        "latency_p50_us": {k[len("obs/latency/"):]: v["p50"]
                           for k, v in snap.items()
                           if k.startswith("obs/latency/")},
        "warm_up_first_spans_s": first_span_s,
        "rates_obs_off": {k: off[k] for k in rate},
        "rates_obs_on": {k: on[k] for k in rate},
        "measured_point_fpr": float((pres & ~ptruth).sum()
                                    / max((~ptruth).sum(), 1)),
        "measured_range_fpr": float((rres & ~rtruth).sum()
                                    / max((~rtruth).sum(), 1)),
        "observed_fpr": ofpr,
    }


def _durable_and_obs(device, kernels, expect, smi):
    """Phases 10 and 11, each printing its line; returns their results."""
    wal_root = tempfile.mkdtemp(prefix="bloomrf-smoke-")
    try:
        t0 = time.perf_counter()
        durable = phase_durable(device, kernels,
                                str(Path(wal_root) / "wal"))
        print(f"[10/17] deletable, durable store (phase 7's settings, "
              f"mutability='deletable', durability='wal'): {STORE_KEYS} "
              f"puts through the WAL, a checkpoint, {durable['deleted']} "
              f"keys deleted in {durable['delete_batches']} delete_many "
              f"batches between the YCSB-E scan batches: every scan == "
              f"numpy oracle of the deletes, {GET_SAMPLE} surviving keys "
              f"read their values and {GET_SAMPLE} deleted keys nothing, "
              f"{durable['launches']} B4 launches for {durable['batches']} "
              f"scan batches, {durable['b1_launches']} B1 launches for "
              f"{durable['filter_builds']} filter builds, no other launch; "
              f"Store.open == the live store (stats, run CRCs, scans), "
              f"{durable['wal_replayed']} WAL frames replayed; a flipped "
              f"filter block restored quarantined, scans exact through B4, "
              f"found by scrub: {json.dumps(durable)} on {smi} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        obs_run = phase_obs(device, kernels,
                            expect(insert=8, point=4, range=4),
                            str(Path(wal_root) / "trace.jsonl"))
        print(f"[11/17] obs on the main path (phase 3's filter and mix, "
              f"obs.enable() and a JSONL trace sink): launches "
              f"{json.dumps(obs_run['launches_on'])} as with obs off, the "
              f"same verdicts and state, kernel/dispatch/resident == calls, "
              f"Counter.add of device tensors under "
              f"set_sync_debug_mode('error'): {json.dumps(obs_run)} on "
              f"{smi} ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)
    return durable, obs_run


# ---------------------------------------------------------------------------
# phase 12: tuner-chosen run stacks, the host baselines, the typed stores
# ---------------------------------------------------------------------------

TUNE_KEYS = 1 << 21       # the adaptive twin's clustered keys (two halves)
TUNE_BATCHES = 8          # near-miss scan batches between the halves
BASE_KEYS = 1 << 18       # keys per host-baseline store (numpy builds)
BASE_SCANS = 2048         # phase 7's scans per host-baseline store
CMP_KEYS = 2_000_000      # the standalone comparison's keys (phase 3's)
CMP_QUERIES = 1 << 16     # its points and ranges
STR_KEYS = 8192           # the str store's keys (a read-modify-write put)
STR_MEMTABLE = 512        # its memtable: 16 flushes, so compactions run
TYPED_KEYS = 200_000      # the multiattr store's keys
TYPED_SCANS = 1000        # the scans of each

def _clustered(rng, n):
    """tests/test_tune.py::_skewed_ops's keys: (u^4) 2^31 + U[0, 2^22)."""
    import numpy as np

    keys = ((rng.random(n) ** 4) * (1 << 31)).astype(np.uint64)
    keys += rng.integers(0, 1 << 22, n, dtype=np.uint64)
    return np.minimum(keys, np.uint64((1 << 32) - 1))


def _absent_range_fpr(st, keys, rng, n=1 << 16, length=256):
    """The reference's acceptance metric: the share of absent ranges of
    ``length`` codes in [2^30, 2^31) that some run's fence and filter pass
    (the store's host plane: the plain ``StackedProbe`` on the card)."""
    import numpy as np

    lo = rng.integers(1 << 30, 1 << 31, n, dtype=np.uint64)
    hi = lo + np.uint64(length - 1)
    ks = np.sort(keys)
    idx = np.searchsorted(ks, lo)
    empty = ~((idx < len(ks)) & (ks[np.minimum(idx, len(ks) - 1)] <= hi))
    fence, filt = st.probe_runs(lo[empty], hi[empty])
    return float((fence & filt).any(axis=1).mean()), int(empty.sum())


def _adaptive_twin(device, kernels, errs):
    """Phase 12 (a): phase 7's store, ``tuning="auto"`` and ``"adaptive"``,
    on the clustered keys: half loaded, TUNE_BATCHES batches of near-miss
    scans (a stored key + 1, 256 codes), the other half loaded, the same
    scans again on the final stacks."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels.store_scan import store_scan_probe_flat

    from repro_torch.core import BloomRF

    rng = np.random.default_rng(SEED + 12)
    keys = _clustered(rng, TUNE_KEYS)
    half = TUNE_KEYS // 2
    n_scans = TUNE_BATCHES * SCAN_BATCH
    lo = np.minimum(keys[rng.integers(0, half, n_scans)] + np.uint64(1),
                    np.uint64((1 << 32) - RSIZE))
    hi = lo + np.uint64(RSIZE - 1)
    out, stores = {}, {}
    for tuning in ("auto", "adaptive"):
        read = _counted(kernels)
        h = repro_torch.open_filter(repro_torch.FilterSpec(
            dtype="u32", placement="store", tuning=tuning, **STORE7))
        builds = _record_builds(h.store, keep=None if tuning == "auto" else
                                lambda lay, k, s=h.store:
                                lay != s.class_layout(len(k)))
        t0 = time.perf_counter()
        for i, k in enumerate(keys[:half]):
            h.put(int(k), i)
        h.flush()
        mid = []
        for s in range(0, n_scans, SCAN_BATCH):
            mid += h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])
        for i, k in enumerate(keys[half:]):
            h.put(int(k), half + i)
        h.flush()
        end = []
        for s in range(0, n_scans, SCAN_BATCH):
            end += h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, st = read(), h.store
        want = {k: 0 for k in kernels}
        want.update(insert=st.filter_builds, store_scan=2 * TUNE_BATCHES)
        if launches != want or st.stats.kernel_fallbacks:
            raise AssertionError(f"{tuning} store: launches {launches}, "
                                 f"{st.filter_builds} builds, "
                                 f"{st.stats.kernel_fallbacks} fallbacks")
        nobatch = [0] * TUNE_BATCHES
        bad = (_scan_mismatches(keys[:half], keys[:0], lo, hi, nobatch, mid)
               + _scan_mismatches(keys, keys[:0], lo, hi, nobatch, end))
        if bad:
            raise AssertionError(f"{tuning} store: {bad} scans differ from "
                                 f"the oracle")
        fpr, n_empty = _absent_range_fpr(st, keys,
                                         np.random.default_rng(SEED ^ 0xF00))
        runs = st.live_runs()
        out[tuning] = {
            "seconds": secs, "puts_per_s": TUNE_KEYS / secs,
            "runs": len(runs), "filter_builds": st.filter_builds,
            "b1_launches": launches["insert"],
            "b4_launches": launches["store_scan"],
            "scan_batches": 2 * TUNE_BATCHES,
            "retunes": st.stats.retunes,
            "rebuild_merges": st.stats.rebuild_merges,
            "or_merges": st.stats.or_merges,
            "runs_probed_per_scan": st.stats.runs_probed_per_scan,
            "scan_fp_read_rate": st.stats.scan_fp_read_rate,
            "absent_range_fpr": fpr, "absent_ranges": n_empty,
            "live_layouts": [[list(r.layout.deltas),
                              list(r.layout.replicas), r.layout.k, len(r)]
                             for r in runs]}
        stores[tuning] = (h, mid, end, builds)
    (hs, mid_s, end_s, _), (ha, mid_a, end_a, tuned_builds) = \
        stores["auto"], stores["adaptive"]
    if mid_s != mid_a or end_s != end_a:
        raise AssertionError("the adaptive twin's scans differ from the "
                             "static twin's")
    st = ha.store
    tuned = [r for r in st.live_runs() if r.layout != st.class_layout(len(r))]
    if st.stats.retunes < 1 or not tuned:
        raise AssertionError(f"no retune landed: {out['adaptive']}")
    if not out["adaptive"]["absent_range_fpr"] \
            < out["auto"]["absent_range_fpr"]:
        raise AssertionError(f"adaptive FPR not below static: "
                             f"{out['adaptive']['absent_range_fpr']} vs "
                             f"{out['auto']['absent_range_fpr']}")
    out["retune_events"] = ha.retune_report()["events"]
    # B1 at the tuner's layouts: every build the adaptive store made at a
    # layout other than its capacity class's, bit for bit against the plain
    # build of the same keys on the card; B1 alone on the smallest and the
    # largest of them
    kept = tuned_builds["kept"]
    if not kept:
        raise AssertionError("the adaptive store built no tuned layout")
    for lay, bkeys, state in kept:
        plain = BloomRF(lay, device=device).build(st._codes(bkeys))
        errs["insert"] = max(errs["insert"], _max_err(state, plain))
    if errs["insert"]:
        raise AssertionError(f"B1 != plain at a tuned layout: {errs}")
    out["tuned_builds_checked"] = len(kept)
    out["tuned_build_keys"] = sum(len(k) for _, k, _ in kept)
    b1 = {}
    for lay, bkeys, _ in (min(kept, key=lambda b: len(b[1])),
                          max(kept, key=lambda b: len(b[1]))):
        name = f"d_tuned_{len(bkeys)}"
        b1[name] = _b1_shape(device, kernels["insert"]["fn"], lay,
                             torch.zeros(lay.total_u32, dtype=torch.int32,
                                         device=device),
                             [st._codes(bkeys)], plain_reps=10)
        b1[name].update(deltas=lay.deltas, replicas=lay.replicas,
                        launches=st.filter_builds)
        errs["insert"] = max(errs["insert"], b1[name]["max_abs_err"])
    if errs["insert"]:
        raise AssertionError(f"B1 alone != plain at a tuned layout: {errs}")
    out["b1_shapes"] = b1
    # B4 on the final tuned stack against its plain version, with the edges
    kmin, kmax, quar = st._device_rows()
    layouts = tuple(r.layout for r in st.live_runs())
    blo, bhi = _scan_bounds_with_edges(np.random.default_rng(SEED + 121),
                                       4096, st._kmins, st._kmaxs)
    tlo, thi = _i64(blo, device), _i64(bhi, device)
    fence, touch = store_scan_probe_flat(layouts, st._bases, st._flat, kmin,
                                         kmax, tlo, thi, quar)
    pf, pt = st._probe.touch_all(st._flat, kmin, kmax, tlo, thi, quar)
    errs["store_scan"] = max(errs["store_scan"], _max_err(fence, pf),
                             _max_err(touch, pt))
    if errs["store_scan"]:
        raise AssertionError(f"B4 != plain on the tuned stack: {errs}")
    # B4 alone on one batch of each final stack
    for tuning, (h, _, _, _) in stores.items():
        s = h.store
        k0, k1, q = s._device_rows()
        lays = tuple(r.layout for r in s.live_runs())
        b_lo, b_hi = _i64(lo[:SCAN_BATCH], device), _i64(hi[:SCAN_BATCH],
                                                         device)
        out[tuning]["b4_ms"] = _graph_ms(lambda: store_scan_probe_flat(
            lays, s._bases, s._flat, k0, k1, b_lo, b_hi, q))
        out[tuning]["b4_plain_ms"] = _cuda_ms(lambda: s._probe.touch_all(
            s._flat, k0, k1, b_lo, b_hi, q), 20)
    out["tuned_stack_cells_checked"] = 4096 * len(layouts)
    return out


def _baseline_stores(device, kernels):
    """Phase 12 (b): phase 7's store with each host baseline as
    ``store_backend`` at BASE_KEYS keys (numpy builds at flush and at every
    compaction set the cut), BASE_SCANS of phase 7's scans exact against
    the oracle, no kernel launched; a bloomRF store on the same stream
    beside them.  A plain Bloom filter answers no ranges (in the reference
    too), so its store takes BASE_SCANS point reads instead."""
    import numpy as np

    import repro_torch

    rng = np.random.default_rng(SEED + 122)
    data = rng.integers(0, 1 << 32, BASE_KEYS, dtype=np.uint64)
    lo = _scan_starts(BASE_SCANS, data, rng)
    hi = _scan_ends(lo)
    pq = np.concatenate([rng.choice(data, BASE_SCANS // 2),
                         rng.integers(0, 1 << 32, BASE_SCANS // 2,
                                      dtype=np.uint64)])
    last = {int(k): i for i, k in enumerate(data)}
    out = {}
    for backend in ("bloomrf", "bloom", "prefix_bloom", "rosetta", "surf"):
        read = _counted(kernels)
        h = repro_torch.open_filter(repro_torch.FilterSpec(
            dtype="u32", placement="store", store_backend=backend,
            **STORE7))
        t0 = time.perf_counter()
        for i, k in enumerate(data):
            h.put(int(k), i)
        h.flush()
        t1 = time.perf_counter()
        row = {"load_s": t1 - t0}
        if backend == "bloom":
            got = h.get_many(pq)
            if got != [last.get(int(k)) for k in pq]:
                raise AssertionError("bloom store: gets differ from the "
                                     "oracle")
            row.update(gets=len(pq),
                       get_fp_read_rate=h.stats.get_fp_read_rate,
                       runs_read_per_get=h.stats.get_run_reads / len(pq))
        else:
            res = []
            for s in range(0, BASE_SCANS, SCAN_BATCH):
                res += h.scan_many(lo[s:s + SCAN_BATCH], hi[s:s + SCAN_BATCH])
            bad = _scan_mismatches(data, data[:0], lo, hi,
                                   [0] * (BASE_SCANS // SCAN_BATCH), res)
            if bad:
                raise AssertionError(f"{backend} store: {bad} scans differ "
                                     f"from the oracle")
            row.update(scans=BASE_SCANS,
                       runs_probed_per_scan=h.stats.runs_probed_per_scan,
                       scan_fp_read_rate=h.stats.scan_fp_read_rate,
                       host_scans_per_s=BASE_SCANS / (time.perf_counter()
                                                      - t1))
        launches, st = read(), h.store
        want = {k: 0 for k in kernels}
        if backend == "bloomrf":
            want.update(insert=st.filter_builds,
                        store_scan=BASE_SCANS // SCAN_BATCH)
        if launches != want:
            raise AssertionError(f"{backend} store launches {launches}")
        row.update(runs=len(st.live_runs()), filter_bits=sum(
                       r.alt.size_bits() if r.alt is not None
                       else r.layout.total_bits for r in st.live_runs()),
                   rebuild_merges=st.stats.rebuild_merges,
                   launches={k: v for k, v in launches.items() if v})
        out[backend] = row
    return out


def _standalone(device, kernels):
    """Phase 12 (c): the paper's standalone comparison on phase 3's keys:
    ``BloomRFAdapter(d=32, bits_per_key=16)`` (one B1 launch per insert
    chunk, one B2 and one B3 for the points and ranges) against Rosetta,
    prefix Bloom, SuRF-lite and Bloom (points only) at 16 bits/key."""
    import dataclasses

    import numpy as np

    import repro_torch
    from repro_torch import filters as F

    n = CMP_KEYS
    rng = np.random.default_rng(SEED + n)            # phase 3's keys
    top = (1 << 32) - 1
    keys = rng.integers(0, top + 1, n, dtype=np.uint64)
    pq, lo, hi = _queries(rng, CMP_QUERIES, keys, top)
    ptruth, rtruth = _truth(keys, pq, lo, hi)

    def fprs(pres, rres):
        row = {"point_fpr": float((pres & ~ptruth).sum()
                                  / max((~ptruth).sum(), 1))}
        fn = int((ptruth & ~pres).sum())
        if rres is not None:
            row["range_fpr"] = float((rres & ~rtruth).sum()
                                     / max((~rtruth).sum(), 1))
            fn += int((rtruth & ~rres).sum())
        if fn:
            raise AssertionError(f"{fn} false negatives")
        return row

    out = {}
    read = _counted(kernels)
    ad = F.BloomRFAdapter(bits_per_key=16, d=32)
    t0 = time.perf_counter()
    ad.build(keys)
    pres, rres = ad.point(pq), ad.range(lo, hi)
    secs = time.perf_counter() - t0
    launches = read()
    chunks = -(-n // ad.chunk)
    want = {k: 0 for k in kernels}
    want.update(insert=chunks, point=1, range=1)
    if launches != want:
        raise AssertionError(f"adapter launches {launches} != {want}")
    twin = repro_torch.open_filter(
        dataclasses.replace(ad.handle.spec, backend="xla"))
    twin.insert(keys)
    if not (np.array_equal(twin.state_numpy(), ad.handle.state_numpy())
            and np.array_equal(twin.point(pq), pres)
            and np.array_equal(twin.range(lo, hi), rres)):
        raise AssertionError("adapter != its xla twin")
    out["bloomrf"] = {**fprs(pres, rres), "seconds": secs,
                      "size_bits": ad.size_bits(),
                      "launches": {k: v for k, v in launches.items() if v}}
    makers = {"rosetta": lambda: F.Rosetta(16, max_range_log2=14),
              "prefix_bloom": lambda: F.PrefixBloomFilter(16),
              "surf": lambda: F.SuRFLite.for_budget(16),
              "bloom": lambda: F.BloomFilter(16)}
    for name, make in makers.items():
        read = _counted(kernels)
        f = make()
        t0 = time.perf_counter()
        f.build(keys)
        t1 = time.perf_counter()
        pres = f.point(pq)
        rres = None if name == "bloom" else f.range(lo, hi)
        t2 = time.perf_counter()
        if any(read().values()):
            raise AssertionError(f"{name} launched a kernel")
        out[name] = {**fprs(pres, rres), "build_s": t1 - t0,
                     "query_s": t2 - t1, "size_bits": f.size_bits()}
    out["queries"] = len(pq)
    return out


def _ycsb_user_keys(rng, n):
    """YCSB's key form: ``user`` and 12 digits."""
    import numpy as np

    nums = rng.choice(10 ** 12, n, replace=False)
    return [f"user{int(x):012d}" for x in nums.astype(np.int64)]


def _typed_stores(device, kernels):
    """Phase 12 (d): a ``str`` store of STR_KEYS YCSB keys (per-code
    buckets, read-modify-write puts) and a ``multiattr`` store of
    TYPED_KEYS ``(a, b)`` pairs, each with TYPED_SCANS scans checked
    against a sorted oracle; d = 64, so no kernel is launched.  Each
    ``str`` put reads its bucket first, a plain d = 64 probe of every run
    on the card and a copy back (about 180 puts/s on the H100 over 8
    runs): that sets the cut from 200,000 keys to STR_KEYS.  Its memtable
    is cut to STR_MEMTABLE (phase 7's 8,192 would never compact), so
    compactions merge runs whose values are buckets; asserted."""
    import bisect

    import numpy as np

    import repro_torch

    rng = np.random.default_rng(SEED + 123)
    read = _counted(kernels)
    out = {}
    words = _ycsb_user_keys(rng, STR_KEYS)
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="str", placement="store",
        **dict(STORE7, memtable_limit=STR_MEMTABLE)))
    t0 = time.perf_counter()
    for i, w in enumerate(words):
        h.put(w, i)
    h.flush()
    t1 = time.perf_counter()
    srt = sorted(words)
    value = {w: i for i, w in enumerate(words)}
    ia = rng.integers(0, len(srt), TYPED_SCANS)
    ib = np.minimum(ia + rng.integers(0, 40, TYPED_SCANS), len(srt) - 1)
    los = [srt[a][:-1] for a in ia]                 # a prefix: just before
    his = [srt[b] for b in ib]
    got = h.scan_many(los, his)
    t2 = time.perf_counter()
    bad = sum(rows != [(w, value[w]) for w in
                       srt[bisect.bisect_left(srt, lo):
                           bisect.bisect_right(srt, hi)]]
              for rows, lo, hi in zip(got, los, his))
    if bad:
        raise AssertionError(f"str store: {bad} scans differ from the oracle")
    if not h.stats.compactions:
        raise AssertionError("str store: no compaction ran")
    out["str"] = {"keys": STR_KEYS, "memtable_limit": STR_MEMTABLE,
                  "scans": TYPED_SCANS,
                  "flushes": h.stats.flushes,
                  "compactions": h.stats.compactions,
                  "multi_key_buckets": sum(
                      len(v) > 1 for r in h.store.live_runs()
                      for v in r.vals if isinstance(v, dict)),
                  "puts_per_s": STR_KEYS / (t1 - t0),
                  "scans_per_s": TYPED_SCANS / (t2 - t1),
                  "rows_returned": sum(map(len, got)),
                  "runs": h.n_runs,
                  "runs_probed_per_scan": h.stats.runs_probed_per_scan}

    a = rng.integers(0, 1 << 10, TYPED_KEYS, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, TYPED_KEYS, dtype=np.uint64)
    m = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="multiattr", placement="store", **STORE7))
    t0 = time.perf_counter()
    for i in range(TYPED_KEYS):
        m.put((int(a[i]), int(b[i])), i)
    m.flush()
    t1 = time.perf_counter()
    pairs = {}
    for i, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        pairs[(x, y)] = i
    order = sorted(pairs)
    qi = rng.integers(0, TYPED_KEYS, TYPED_SCANS)
    qa = a[qi]
    blo = np.maximum(b[qi], np.uint64(1 << 24)) - np.uint64(1 << 24)
    bhi = np.minimum(b[qi] + np.uint64(1 << 24), np.uint64((1 << 32) - 1))
    got = m.scan_many((qa, blo), (qa, bhi))
    t2 = time.perf_counter()
    bad = 0
    for rows, x, l, u in zip(got, qa.tolist(), blo.tolist(), bhi.tolist()):
        s = bisect.bisect_left(order, (x, l))
        e = bisect.bisect_right(order, (x, u))
        bad += rows != [(k, pairs[k]) for k in order[s:e]]
    if bad:
        raise AssertionError(f"multiattr store: {bad} scans differ from the "
                             f"oracle")
    out["multiattr"] = {"keys": TYPED_KEYS, "scans": TYPED_SCANS,
                        "puts_per_s": TYPED_KEYS / (t1 - t0),
                        "scans_per_s": TYPED_SCANS / (t2 - t1),
                        "rows_returned": sum(map(len, got)),
                        "runs": m.n_runs,
                        "runs_probed_per_scan":
                            m.stats.runs_probed_per_scan}
    launches = read()
    if any(launches.values()):
        raise AssertionError(f"typed stores launched kernels: {launches}")
    out["launches"] = launches
    return out


def phase_tuned(device, kernels, errs, smi):
    """Phase 12, each part printing its line; returns their results."""
    t0 = time.perf_counter()
    twin = _adaptive_twin(device, kernels, errs)
    print(f"[12/17] (a) adaptive twin: phase 7's store, tuning 'auto' and "
          f"'adaptive', {TUNE_KEYS} clustered keys, {TUNE_BATCHES} batches "
          f"of near-miss scans between the halves and after: retunes "
          f"{twin['adaptive']['retunes']}, scans == static twin == oracle, "
          f"B1 == builds, B4 == batches, B4 == plain on the tuned stack "
          f"({twin['tuned_stack_cells_checked']} cells, edges), absent-range "
          f"FPR {twin['adaptive']['absent_range_fpr']:.4f} (adaptive) < "
          f"{twin['auto']['absent_range_fpr']:.4f} (static): "
          f"{json.dumps(twin)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    base = _baseline_stores(device, kernels)
    print(f"[12/17] (b) host baselines as store_backend, {BASE_KEYS} keys "
          f"each (phase 7's settings), {BASE_SCANS} of phase 7's scans == "
          f"oracle (bloom: {BASE_SCANS} gets), no kernel launched; bloomRF "
          f"on the same stream beside them: {json.dumps(base)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    cmp_ = _standalone(device, kernels)
    print(f"[12/17] (c) standalone comparison on phase 3's {CMP_KEYS} keys at "
          f"16 bits/key, {CMP_QUERIES} points (half present) and ranges "
          f"(2^0..2^14): no false negatives, the adapter == its xla twin: "
          f"{json.dumps(cmp_)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    typed = _typed_stores(device, kernels)
    print(f"[12/17] (d) a str store of {STR_KEYS} keys (memtable "
          f"{STR_MEMTABLE}, compactions asserted) and a multiattr "
          f"store of {TYPED_KEYS}, {TYPED_SCANS} scans each == sorted "
          f"oracle, no kernel launched: "
          f"{json.dumps(typed)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"twin": twin, "baselines": base, "standalone": cmp_,
            "typed": typed}


# ---------------------------------------------------------------------------
# phase 13: the filter bank, the tenant bank and the prefix cache
# ---------------------------------------------------------------------------

BANK_KEYS = 16_000_000    # the bank's keys: 2,000,000 a shard (phase 3's)
BANK_SHARDS = 8           # benchmarks/dist_bench.py's 8-device mesh
TEN_KEYS = 1_000_000      # keys per tenant
TENANTS = 16              # dist_bench.py's tenants and tenant shards
TEN_SHARDS = 4
BANK_QUERIES = 1 << 20    # phase 3's points and ranges
SPAN_RANGES = 1 << 16     # ranges spanning 2-3 shards
TTL_KEYS = 1_000_000      # keys a TTL window (4 windows, 4 generations)
PC_SEGMENTS = 64          # the prefix cache's frozen segments
PC_SESSIONS = 512         # sessions a segment, PC_CHUNKS chunks each
PC_CHUNKS = 8             # (4,096 entries a segment)
PC_LOOKUPS = 1000         # half of them hits
PC_SESSION_QUERIES = 256
PC_SWEEPS = 8             # evict_window sweeps
SHARD_PROBES = 1 << 16    # the sharded variants' points and ranges
BANK_SPEC = dict(dtype="u32", bits_per_key=14.0, delta=6)


def _bank_ranges(rng, n, d_local, shards, top):
    """Ranges that span 2-3 shards of ``2^d_local`` codes, then the
    domain's and the shards' edges."""
    import numpy as np

    width = 1 << d_local
    b = rng.integers(1, shards, n).astype(np.uint64) * np.uint64(width)
    lo = b - rng.integers(1, width // 2, n, dtype=np.uint64)
    hi = np.minimum(b + rng.integers(0, width + width // 2, n,
                                     dtype=np.uint64), np.uint64(top))
    edges = [(0, top), (0, 0), (top, top), (width - 1, width),
             (top - width, top), (width, 2 * width - 1)]
    return (np.concatenate([lo, np.asarray([e[0] for e in edges],
                                           np.uint64)]),
            np.concatenate([hi, np.asarray([e[1] for e in edges],
                                           np.uint64)]))


def _owners(chunks, row_of) -> int:
    """Rows that own keys, summed over the chunks: the B1 launches of a
    bank build (one launch per row that owns keys of a chunk)."""
    import numpy as np

    return int(sum(len(np.unique(row_of(c))) for c in chunks))


def _bank_probe_times(device, lay, stack, keys, rows_label):
    """B6 alone over a bank's rows at one chunk (the whole stack read once,
    the verdicts written once), against the plain ``point_all``."""
    from repro_torch.core import stacked_probe
    from repro_torch.kernels import point_probe_stacked_resident

    R, U = stack.shape
    probe = stacked_probe((lay,) * R, tuple(r * U for r in range(R)), device)
    flat = stack.reshape(-1)
    err = _max_err(point_probe_stacked_resident(lay, stack, keys),
                   probe.point_all(flat, keys))
    n = keys.numel()
    floor = _floor_ms(device, _grid(n), 256, 0, R, param=True)
    row = _times(lambda: point_probe_stacked_resident(lay, stack, keys),
                 lambda: probe.point_all(flat, keys), 3,
                 n * 8 + R * U * 4 + n * R, floor)
    row.pop("call_ms")
    row.update(rows=R, lanes_per_row=U, queries=n, shape=rows_label,
               max_abs_err=err)
    return row


def _bank13(device, kernels, errs):
    """(a) the bank at full width through ``open_filter``, against truth on
    the card, its ``xla`` twin and the plain versions of B1 and B6."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import insert_resident

    rng = np.random.default_rng(SEED + 13)
    top = (1 << 32) - 1
    keys = rng.integers(0, top + 1, BANK_KEYS, dtype=np.uint64)
    pq, lo, hi = _queries(rng, BANK_QUERIES, keys, top)
    spec = dict(n=BANK_KEYS, placement="bank", shards=BANK_SHARDS,
                **BANK_SPEC)
    h = repro_torch.open_filter(repro_torch.FilterSpec(**spec))
    bank = h.bank
    slo, shi = _bank_ranges(rng, SPAN_RANGES, bank.d_local, BANK_SHARDS, top)
    chunks = [keys[s:s + CHUNK] for s in range(0, BANK_KEYS, CHUNK)]
    expect_b1 = _owners(chunks, lambda c: c >> np.uint64(bank.d_local))

    read = _counted(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h.insert(keys)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    built = read()
    pres = h.point(pq)
    t2 = time.perf_counter()
    probed = read()
    _counted(kernels)
    rres = h.range(lo, hi)
    t3 = time.perf_counter()
    sres = h.range(slo, shi)
    ranged = read()
    if built["insert"] != expect_b1 or sum(built.values()) != expect_b1:
        raise AssertionError(f"bank build launches {built}, expected "
                             f"{expect_b1} B1 launches and no other")
    n_pchunks = _chunks(len(pq))
    if probed["point_stacked"] - built["point_stacked"] != n_pchunks \
            or sum(probed.values()) != expect_b1 + n_pchunks:
        raise AssertionError(f"bank point launches {probed}")
    if sum(ranged.values()):
        raise AssertionError(f"a bank range launched a kernel: {ranged}")

    sk = torch.sort(_i64(keys, device)).values
    ptruth, rtruth = _truth_on_card(sk, pq, lo, hi, device)
    _, struth = _truth_on_card(sk, pq[:1], slo, shi, device)
    fn = {"point": int((ptruth & ~pres).sum()),
          "range": int((rtruth & ~rres).sum()),
          "span": int((struth & ~sres).sum())}
    if any(fn.values()):
        raise AssertionError(f"bank false negatives {fn}")
    twin = repro_torch.open_filter(repro_torch.FilterSpec(backend="xla",
                                                          **spec))
    twin.insert(keys)
    if not torch.equal(twin.state, h.state):
        raise AssertionError("B1-built bank != the plain masked build")
    if not (np.array_equal(twin.point(pq), pres)
            and np.array_equal(twin.range(lo, hi), rres)
            and np.array_equal(twin.range(slo, shi), sres)):
        raise AssertionError("bank verdicts differ from the xla twin")
    low = _i64(pq[:CHUNK] & np.uint64((1 << bank.d_local) - 1), device)
    b6 = _bank_probe_times(device, bank.layout, h.state, low,
                           f"bank {BANK_SHARDS} rows")
    errs["point_stacked"] = max(errs["point_stacked"], b6["max_abs_err"])
    row0 = keys[:CHUNK][(keys[:CHUNK] >> np.uint64(bank.d_local)) == 0]
    b1 = _b1_shape(device, insert_resident, bank.layout, h.state[0].clone(),
                   [_i64(row0, device)])
    return h, (pq, lo, hi, slo, shi), {
        "rows": BANK_SHARDS, "lanes_per_row": bank.layout.total_u32,
        "state_mib": BANK_SHARDS * bank.layout.total_u32 * 4 / 2**20,
        "deltas": bank.layout.deltas, "keys": BANK_KEYS,
        "launches": {"build": built["insert"],
                     "points": probed["point_stacked"],
                     "ranges": sum(ranged.values())},
        "point_chunks": n_pchunks,
        "point_fpr": float((pres & ~ptruth).sum() / max((~ptruth).sum(), 1)),
        "range_fpr": float((rres & ~rtruth).sum() / max((~rtruth).sum(), 1)),
        "span_ranges": len(slo), "span_positive": float(sres.mean()),
        "insert_keys_per_s": BANK_KEYS / (t1 - t0),
        "point_queries_per_s": len(pq) / (t2 - t1),
        "range_queries_per_s": len(lo) / (t3 - t2),
        "b6": b6, "b1_row": b1}


def _tenant_truth(sorted_packed, pten, pq, rten, lo, hi, device):
    """Point and range truth per tenant, from the keys packed as ``tenant
    << 32 | key`` and sorted on the card."""
    import numpy as np

    def packed(t, k):
        return (np.asarray(t, np.uint64) << np.uint64(32)) | k

    return _truth_on_card(sorted_packed, packed(pten, pq), packed(rten, lo),
                          packed(rten, hi), device)


def _tenant13(device, kernels, errs):
    """(b) the tenant bank: the same mix with random tenants, ranges with
    and without meta, ``meta_skip_stats``, ``grow(4)`` in place, and a TTL
    twin over 4 generations, each against its ``xla`` twin."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import insert_resident

    rng = np.random.default_rng(SEED + 131)
    top = (1 << 32) - 1
    n = TEN_KEYS * TENANTS
    keys = rng.integers(0, top + 1, n, dtype=np.uint64)
    ten = rng.integers(0, TENANTS, n).astype(np.uint32)
    pq, lo, hi = _queries(rng, BANK_QUERIES, keys, top)
    pick = rng.integers(0, n, BANK_QUERIES // 2)
    pq[:BANK_QUERIES // 2] = keys[pick]
    pten = rng.integers(0, TENANTS, BANK_QUERIES).astype(np.uint32)
    pten[:BANK_QUERIES // 2] = ten[pick]
    rten = rng.integers(0, TENANTS, BANK_QUERIES).astype(np.uint32)
    spec = dict(n=TEN_KEYS, placement="tenant", tenants=TENANTS,
                shards=TEN_SHARDS, **BANK_SPEC)
    h = repro_torch.open_filter(repro_torch.FilterSpec(**spec))
    tb = h.bank
    dl = np.uint64(tb.bank.d_local)
    expect_b1 = 2 * _owners(
        [np.stack([ten[s:s + CHUNK], keys[s:s + CHUNK] >> dl])
         for s in range(0, n, CHUNK)],
        lambda c: c[0].astype(np.uint64) * np.uint64(TEN_SHARDS) + c[1])

    read = _counted(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h.insert(ten, keys)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    built = read()
    pres = h.point(pten, pq)
    t2 = time.perf_counter()
    probed = read()
    _counted(kernels)
    gated = h.range(rten, lo, hi)
    t3 = time.perf_counter()
    plain = h.range(rten, lo, hi, use_meta=False)
    t4 = time.perf_counter()
    ranged = read()
    n_pchunks = _chunks(len(pq))
    if built["insert"] != expect_b1 or sum(built.values()) != expect_b1:
        raise AssertionError(f"tenant build launches {built}, expected "
                             f"{expect_b1} B1 launches and no other")
    if probed["point_stacked"] != n_pchunks \
            or sum(probed.values()) != expect_b1 + n_pchunks:
        raise AssertionError(f"tenant point launches {probed}")
    if sum(ranged.values()):
        raise AssertionError(f"a tenant range launched a kernel: {ranged}")
    packed = (ten.astype(np.uint64) << np.uint64(32)) | keys
    sp = torch.sort(_i64(packed, device)).values
    ptruth, rtruth = _tenant_truth(sp, pten, pq, rten, lo, hi, device)
    fn = {"point": int((ptruth & ~pres).sum()),
          "range_meta": int((rtruth & ~gated).sum()),
          "range": int((rtruth & ~plain).sum())}
    if any(fn.values()) or (gated & ~plain).any():
        raise AssertionError(f"tenant false negatives {fn}, or meta "
                             f"widened a verdict")
    cand = skip = 0
    for s in range(0, len(lo), CHUNK):
        c, k = tb.meta_skip_stats(
            h.meta, _i64(rten[s:s + CHUNK], device),
            _i64(lo[s:s + CHUNK], device), _i64(hi[s:s + CHUNK], device))
        cand, skip = cand + int(c), skip + int(k)
    twin = repro_torch.open_filter(repro_torch.FilterSpec(backend="xla",
                                                          **spec))
    twin.insert(ten, keys)
    if not (torch.equal(twin.state, h.state)
            and torch.equal(twin.meta, h.meta)):
        raise AssertionError("B1-built tenant rows != the plain build")
    if not (np.array_equal(twin.point(pten, pq), pres)
            and np.array_equal(twin.range(rten, lo, hi), gated)
            and np.array_equal(twin.range(rten, lo, hi, use_meta=False),
                               plain)):
        raise AssertionError("tenant verdicts differ from the xla twin")
    low = _i64(pq[:CHUNK] & np.uint64((1 << tb.bank.d_local) - 1), device)
    R = TENANTS * TEN_SHARDS
    b6 = _bank_probe_times(device, tb.bank.layout, h.state.view(R, -1), low,
                           f"tenant {R} rows")
    errs["point_stacked"] = max(errs["point_stacked"], b6["max_abs_err"])
    own = (ten[:CHUNK] == 0) & ((keys[:CHUNK] >> dl) == 0)
    rk = _i64(keys[:CHUNK][own] & np.uint64((1 << tb.bank.d_local) - 1),
              device)
    b1 = _b1_shape(device, insert_resident, tb.bank.layout,
                   h.state[0, 0].clone(), [rk])
    from repro_torch.core import dyadic_prefixes

    b1_meta = _b1_shape(device, insert_resident, tb.meta_layout,
                        h.meta[0, 0].clone(),
                        [dyadic_prefixes(rk, tb.meta_level,
                                         tb.bank.d_local).contiguous()])

    # grow(4) in place: every key still found, the same verdicts as the twin
    _counted(kernels)
    t5 = time.perf_counter()
    for x in (h, twin):
        x.grow(4)
    found = h.point(ten, keys)
    t6 = time.perf_counter()
    grown = read()
    if not found.all():
        raise AssertionError(f"{int((~found).sum())} keys lost by grow(4)")
    if grown["point_stacked"] != _chunks(n) or grown["insert"]:
        raise AssertionError(f"grown tenant launches {grown}")
    if not (torch.equal(twin.state, h.state)
            and torch.equal(twin.meta, h.meta)
            and np.array_equal(twin.range(rten, lo, hi),
                               h.range(rten, lo, hi))
            and np.array_equal(twin.point(pten, pq), h.point(pten, pq))):
        raise AssertionError("grown tenant bank != its xla twin")

    # the TTL twin: 4 windows of TTL_KEYS, 4 generations, 4 advances
    ttl = [repro_torch.open_filter(repro_torch.FilterSpec(
        backend=b, mutability="ttl", generations=4, **spec))
        for b in ("auto", "xla")]
    wins = [(rng.integers(0, TENANTS, TTL_KEYS).astype(np.uint32),
             rng.integers(0, top + 1, TTL_KEYS, dtype=np.uint64))
            for _ in range(4)]
    _counted(kernels)
    for t, k in wins:
        for x in ttl:
            x.insert(t, k)
            x.advance_generation()
    ttl_b1 = read()["insert"]
    if not (torch.equal(ttl[0].state, ttl[1].state)
            and torch.equal(ttl[0].meta, ttl[1].meta)):
        raise AssertionError("TTL tenant bank != its xla twin")
    kept = all(ttl[0].point(t, k).all() for t, k in wins[1:])
    retired = float(ttl[0].point(*wins[0]).mean())
    if not kept or not np.array_equal(ttl[0].range(rten, lo, hi),
                                      ttl[1].range(rten, lo, hi)):
        raise AssertionError("TTL tenant bank lost a retained window, or "
                             "differs from its twin")
    return h, (pten, pq, rten, lo, hi), {
        "rows": R, "lanes_per_row": tb.bank.layout.total_u32,
        "meta_lanes_per_row": tb.meta_layout.total_u32,
        "meta_level": tb.meta_level, "keys": n,
        "state_mib": R * (tb.bank.layout.total_u32
                          + tb.meta_layout.total_u32) * 4 / 2**20,
        "launches": {"build": built["insert"],
                     "points": probed["point_stacked"],
                     "ranges": sum(ranged.values()),
                     "grown_points": grown["point_stacked"],
                     "ttl_build": ttl_b1},
        "point_fpr": float((pres & ~ptruth).sum() / max((~ptruth).sum(), 1)),
        "range_fpr": float((plain & ~rtruth).sum() / max((~rtruth).sum(), 1)),
        "range_fpr_meta": float((gated & ~rtruth).sum()
                                / max((~rtruth).sum(), 1)),
        "meta_skip_stats": {"candidates": cand, "skipped": skip,
                            "share": skip / max(cand, 1)},
        "insert_keys_per_s": n / (t1 - t0),
        "point_queries_per_s": len(pq) / (t2 - t1),
        "range_meta_queries_per_s": len(lo) / (t3 - t2),
        "range_queries_per_s": len(lo) / (t4 - t3),
        "grown_lanes_per_row": h.bank.bank.layout.total_u32,
        "grown_points_per_s": n / (t6 - t5),
        "ttl_retired_window_positive": retired,
        "b6": b6, "b1_row": b1, "b1_meta_row": b1_meta}


def _prefix_sequence(device, wal_dir):
    """The prefix-cache sequence of (c) on ``device``: returns what every
    call answered, the stats dict, the timings and the evicted keys."""
    import numpy as np

    from repro_torch.serve import PrefixCacheIndex, pack_key
    from repro_torch.store import Store, StoreConfig

    cfg = dict(STORE7)
    cfg.pop("bits_per_key")
    store = Store(StoreConfig(d=32, bits_per_key=STORE7["bits_per_key"],
                              durability="wal", wal_dir=wal_dir, **cfg),
                  device=device)
    idx = PrefixCacheIndex(bits_per_key=14, n_tenants=16,
                           backing_store=store, ttl_generations=4,
                           device=device)
    rng = np.random.default_rng(SEED + 132)
    out, frozen, times = [], [], {}
    t0 = time.perf_counter()
    for seg in range(PC_SEGMENTS):
        ses = rng.choice(1 << 16, PC_SESSIONS, replace=False)
        entries = {pack_key(int(s), c): [seg, int(s), c] for s in ses
                   for c in range(PC_CHUNKS)}
        frozen.append(ses)
        idx.freeze_segment(entries)
        if seg % (PC_SEGMENTS // 4) == PC_SEGMENTS // 4 - 1 \
                and seg + 1 < PC_SEGMENTS:    # four TTL windows of segments
            idx.advance_generation()
    times["freeze_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    missed = 0
    for i in range(PC_LOOKUPS):
        if i % 2 == 0:                      # a cached prefix
            seg = int(rng.integers(0, PC_SEGMENTS))
            s = int(rng.choice(frozen[seg]))
            c = int(rng.integers(0, PC_CHUNKS))
            got = idx.lookup(s, c)
            missed += got is None or got[1:] != [s, c]
        else:
            got = idx.lookup(int(rng.integers(0, 1 << 16)),
                             int(rng.integers(PC_CHUNKS, 1 << 16)))
        out.append(got)
    times["lookups_per_s"] = PC_LOOKUPS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for _ in range(PC_SESSION_QUERIES):
        seg = int(rng.integers(0, PC_SEGMENTS))
        segs = idx.session_segments(int(rng.choice(frozen[seg])))
        missed += seg not in segs
        out.append(segs)
    times["session_queries_per_s"] = PC_SESSION_QUERIES / (
        time.perf_counter() - t0)
    t0 = time.perf_counter()
    evicted = []
    for w in range(PC_SWEEPS):
        lo_s = w * 4096 + int(rng.integers(0, 2048))
        out.append(idx.evict_window(lo_s, lo_s + 255))
        evicted += [pack_key(s, c) for seg in frozen for s in seg
                    if lo_s <= s <= lo_s + 255 for c in range(PC_CHUNKS)]
    times["sweeps_per_s"] = PC_SWEEPS / (time.perf_counter() - t0)
    out.append(idx.advance_generation())
    store.checkpoint()
    store.close()
    t0 = time.perf_counter()
    idx.reopen_cold_tier(wal_dir)
    times["reopen_s"] = time.perf_counter() - t0
    sample = evicted[::max(len(evicted) // 500, 1)]
    back = [idx.lookup(k >> 16, k & 0xFFFF) for k in sample]
    out.append(back)
    return out, dict(idx.stats), dict(
        times, missed=missed, back=sum(x is not None for x in back),
        evicted_sampled=len(sample), lookups=PC_LOOKUPS + len(sample),
        groups=len(idx._groups()), store_filter_builds=store.filter_builds)


def _prefix13(device, kernels):
    """(c) the prefix cache on the card with a durable backing store,
    against a CPU run of the port on the same sequence."""
    wal_root = tempfile.mkdtemp(prefix="bloomrf-smoke-pc-")
    try:
        read = _counted(kernels)
        t0 = time.perf_counter()
        out, stats, info = _prefix_sequence(device,
                                            str(Path(wal_root) / "card"))
        secs = time.perf_counter() - t0
        launches = read()
        cpu = _prefix_sequence("cpu", str(Path(wal_root) / "cpu"))
        secs_cpu = time.perf_counter() - t0 - secs
    finally:
        shutil.rmtree(wal_root, ignore_errors=True)
    if info["missed"]:
        raise AssertionError(f"the prefix cache missed {info['missed']} "
                             f"cached prefixes or their segments")
    if info["back"]:
        raise AssertionError(f"{info['back']} of {info['evicted_sampled']} "
                             f"evicted keys came back after reopen")
    if (out, stats) != cpu[:2]:
        raise AssertionError(f"prefix cache on the card != its CPU run: "
                             f"{stats} vs {cpu[1]}")
    # one B6 launch a lookup (all segments of a bank in one launch), one
    # B4 launch a sweep's store scan
    if launches["point_stacked"] != info["lookups"] * info["groups"] \
            or launches["store_scan"] != PC_SWEEPS:
        raise AssertionError(f"prefix cache launches {launches}: "
                             f"{info['lookups']} lookups, {PC_SWEEPS} "
                             f"sweeps")
    return {"segments": PC_SEGMENTS,
            "entries": PC_SEGMENTS * PC_SESSIONS * PC_CHUNKS,
            "stats": stats, "launches": launches,
            "card_s": secs, "cpu_s": secs_cpu, **info}


def _sharded13(device, bank_h, bank_q, ten_h, ten_q):
    """(d) both sharded variants on an NCCL world of one, each against its
    unsharded bank on SHARD_PROBES of (a)'s and (b)'s queries."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist import ShardedFilterBank, ShardedTenantFilterBank

    root = tempfile.mkdtemp(prefix="bloomrf-smoke-pg-")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{root}/pg",
                            rank=0, world_size=1)
    try:
        pq, lo, hi = (_i64(a[:SHARD_PROBES], device) for a in bank_q[:3])
        bank, state = bank_h.bank, bank_h.state
        sb = ShardedFilterBank(bank)
        local = sb.shard_state(state)
        ok = (torch.equal(sb.point(local, pq), bank.point(state, pq))
              and torch.equal(sb.range(local, lo, hi),
                              bank.range(state, lo, hi)))
        tb, st, me = ten_h.bank, ten_h.state, ten_h.meta
        pten, tq, rten, tlo, thi = (_i64(a[:SHARD_PROBES], device)
                                    for a in ten_q)
        stb = ShardedTenantFilterBank(tb)
        ls, lm = stb.shard_state(st), stb.shard_meta(me)
        ok &= torch.equal(stb.point(ls, pten, tq), tb.point(st, pten, tq))
        for m, wm in ((None, None), (lm, me)):
            ok &= torch.equal(stb.range(ls, rten, tlo, thi, m),
                              tb.range(st, rten, tlo, thi, wm))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(root, ignore_errors=True)
    if not ok:
        raise AssertionError("a sharded bank differs from its bank")
    return {"world": 1, "backend": backend, "probes": SHARD_PROBES}


def phase_banks(device, kernels, errs, smi):
    """Phase 13, each part printing its line; returns their results."""
    t0 = time.perf_counter()
    bank_h, bank_q, bank = _bank13(device, kernels, errs)
    print(f"[13/17] (a) bank: open_filter(FilterSpec(u32, n={BANK_KEYS}, 14 "
          f"bits/key, delta 6, placement='bank', shards={BANK_SHARDS})), "
          f"{BANK_KEYS} inserts in {CHUNK}-key chunks, {BANK_QUERIES} points "
          f"and ranges, {SPAN_RANGES} ranges across 2-3 shards and the "
          f"edges: no false negatives, state and verdicts == xla twin, B1 "
          f"== rows owning keys per chunk, one B6 launch per point chunk, "
          f"no launch for a range: {json.dumps(bank)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    ten_h, ten_q, tenant = _tenant13(device, kernels, errs)
    print(f"[13/17] (b) tenant bank: FilterSpec(u32, n={TEN_KEYS}, "
          f"placement='tenant', tenants={TENANTS}, shards={TEN_SHARDS}), "
          f"{TEN_KEYS * TENANTS} inserts with random tenants, the same mix, "
          f"ranges with and without meta, meta_skip_stats, grow(4) in "
          f"place, a TTL twin (4 generations, 4 windows of {TTL_KEYS}): no "
          f"false negatives, == xla twins, B1 == main and meta rows owning "
          f"keys per chunk, one B6 launch per point chunk, no launch for a "
          f"range: {json.dumps(tenant)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    prefix = _prefix13(device, kernels)
    print(f"[13/17] (c) prefix cache: PrefixCacheIndex(bits_per_key=14, "
          f"n_tenants=16, ttl_generations=4) over a WAL store (phase 10's "
          f"settings), {PC_SEGMENTS} segments of "
          f"{PC_SESSIONS * PC_CHUNKS} entries, {PC_LOOKUPS} lookups (half "
          f"hits), {PC_SESSION_QUERIES} session_segments, {PC_SWEEPS} "
          f"evict_window sweeps, advance_generation, reopen_cold_tier: no "
          f"cached prefix missed, evicted keys stay evicted, stats and "
          f"answers == the CPU run, one B6 launch a lookup, one B4 a "
          f"sweep: {json.dumps(prefix)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    sharded = _sharded13(device, bank_h, bank_q, ten_h, ten_q)
    print(f"[13/17] (d) ShardedFilterBank and ShardedTenantFilterBank on an "
          f"NCCL world of 1 == their banks on {SHARD_PROBES} of (a)'s and "
          f"(b)'s points and ranges (with and without meta): "
          f"{json.dumps(sharded)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return {"bank": bank, "tenant": tenant, "prefix": prefix,
            "sharded": sharded}


SERVE_ARCH = "qwen3-1.7b"
SERVE_BAND = (1.5e9, 2.7e9)   # tests/test_models.py's band for qwen3-1.7b
SERVE_MAX_SEQ = 512
SERVE_SLOTS = 4               # one batch: sessions 0-3
SERVE_CHUNK = 64
SERVE_PROMPT = 256            # 4 whole chunks a prompt
SERVE_NEW = 32
GREEDY_PROMPT, GREEDY_NEW = 12, 5     # tests/test_serve_data.py's sizes
CONSIST_B, CONSIST_T = 2, 64
CARD_CPU_LAYERS = 2
#: card against CPU, f32 with TF32 off: the two sum the same f32 products
#: in other orders (up to d_ff = 6,144 terms), ~1e-6 of a logit; one bf16
#: rounding is 2^-8 = 3.9e-3, so a path that rounds to bf16 fails
CARD_CPU_TOL = 1e-3
PAGE_SIZE = 16


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, log: list, device):
    """``fn`` with each call's host seconds, closed by a device
    synchronize, appended to ``log``."""
    def call(*a, **kw):
        _sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(device)
        log.append(time.perf_counter() - t0)
        return out
    return call


def _serve_model(device, arch, band, cfg=None):
    """The model of ``arch`` (or of ``cfg``, a cut of it) at full width on
    the card from a seeded generator; ``count_params`` == the leaves'
    elements, in ``band`` where there is one."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.params import count_params, tree_leaves

    cfg = cfg or get_config(arch)
    model = get_model(cfg, device)
    n = count_params(model.table())
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device).manual_seed(SEED))
    _sync(device)
    leaves = tree_leaves(params)
    elems = sum(t.numel() for t in leaves)
    if n != elems or (band and not band[0] < n < band[1]):
        raise AssertionError(f"{cfg.name}: count_params {n}, leaves "
                             f"{elems}, band {band}")
    return cfg, model, params, {
        "params": n, "band": band, "param_bytes": sum(
            t.numel() * t.element_size() for t in leaves),
        "init_s": time.perf_counter() - t0}


def _serve_loop(device, kernels, cfg, model, params, prompt=SERVE_PROMPT,
                new=SERVE_NEW, slots=SERVE_SLOTS):
    """(b) the loop over two batches of the same ``slots`` sessions
    (prompts of ``prompt`` tokens, ``new`` new tokens each), its index
    calls replayed on a CPU twin; returns the numbers, batch 1's final
    cache and the prompts."""
    import numpy as np

    from repro_torch.serve import PrefixCacheIndex, Request, ServeLoop

    rng = np.random.default_rng(SEED + 14)
    prompts = [rng.integers(0, cfg.vocab - 1, prompt).astype(np.int32)
               for _ in range(slots)]
    requests = [Request(session=s, prompt=prompts[s], max_new_tokens=new)
                for _ in range(2) for s in range(slots)]
    loop = ServeLoop(model, params, max_seq=SERVE_MAX_SEQ,
                     batch_slots=slots, prefix_chunk=SERVE_CHUNK,
                     device=device)
    pre_s, dec_s, look_s, calls, held = [], [], [], [], {}
    decode = _timed(loop._decode, dec_s, device)

    def keep_last(*a):
        held["last"] = out = decode(*a)
        return out

    loop._prefill = _timed(loop._prefill, pre_s, device)
    loop._decode = keep_last
    idx, b6 = loop.index, kernels["point_stacked"]["fn"]
    lookup = _timed(idx.lookup, look_s, device)
    freeze = idx.freeze_segment

    def logged_lookup(session, chunk):
        before = b6.launches
        got = lookup(session, chunk)
        calls.append(("lookup", (session, chunk), got,
                      b6.launches - before))
        return got

    def logged_freeze(entries):
        held.setdefault("batch1", held["last"][1])
        got = freeze(entries)
        calls.append(("freeze_segment", (entries,), got, 0))
        return got

    idx.lookup, idx.freeze_segment = logged_lookup, logged_freeze
    read = _counted(kernels)
    t0 = time.perf_counter()
    done = loop.run(requests)
    run_s = time.perf_counter() - t0
    launches = read()

    twin = PrefixCacheIndex(device="cpu")
    for name, args, got, _ in calls:
        if getattr(twin, name)(*args) != got:
            raise AssertionError(f"{name}{args[:2]}: card {got}")
    if dict(idx.stats) != twin.stats:
        raise AssertionError(f"index stats {idx.stats} != CPU {twin.stats}")
    chunks = prompt // SERVE_CHUNK
    per_batch = slots * chunks
    per_lookup = [n for name, _, _, n in calls if name == "lookup"]
    tenants = len({s & (idx.n_tenants - 1) for s in range(slots)})
    # each frozen segment builds its tenants' main and meta rows: one B1
    # launch per row that owns keys
    b1 = 2 * 2 * tenants
    expect = {k: {"insert": b1, "point_stacked": per_batch}.get(k, 0)
              for k in kernels}
    if launches != expect or per_lookup != [0] * per_batch + [1] * per_batch:
        raise AssertionError(f"serve launches {launches} (expected "
                             f"{expect}), per lookup {per_lookup}")
    if idx.stats["map_hits"] != per_batch or any(
            len(r.out_tokens) != new for r in done):
        raise AssertionError(f"serve stats {idx.stats}")
    if not all(0 <= t < cfg.vocab for r in done for t in r.out_tokens):
        raise AssertionError("a sampled token is outside the vocab")
    steps = len(dec_s)
    info = {
        "requests": len(done), "batches": 2, "prompt_tokens": prompt,
        "new_tokens": new, "lookups": len(per_lookup),
        "segments": len(idx.segments), "stats": dict(idx.stats),
        "launches": {k: v for k, v in launches.items() if v},
        "prefill_s": pre_s, "decode_steps": steps,
        "prefill_tokens_per_s": 2 * slots * prompt / sum(pre_s),
        "decode_steps_per_s": steps / sum(dec_s),
        "decode_tokens_per_s": steps * slots / sum(dec_s),
        "decode_step_ms_median": 1e3 * float(np.median(dec_s)),
        "lookups_per_s_no_segment": per_batch / sum(look_s[:per_batch]),
        "lookups_per_s_one_segment": per_batch / sum(look_s[per_batch:]),
        "run_s": run_s}
    return info, held["batch1"], np.stack(prompts)


def _serve_profile(device, model, params, cache, prompts, pos):
    """Where a step's time goes: a decode step against ``cache`` and a
    prefill of ``prompts``, the device's share of each one's wall time."""
    import torch

    token = torch.zeros((len(prompts), 1), dtype=torch.int32, device=device)
    return {"decode_step": _device_busy(lambda: model.decode(
                params, cache, {"token": token, "pos": pos})),
            "prefill": _device_busy(lambda: model.prefill(
                params, {"tokens": prompts}), reps=2)}


@contextlib.contextmanager
def _routes(seen):
    """Every MoE layer's routing (``repro_torch.models.moe.route``) passed
    to ``seen`` while the block runs."""
    from repro_torch.models import moe

    route = moe.route

    def logged(p, cfg, xg):
        r = route(p, cfg, xg)
        seen(r)
        return r

    moe.route = logged
    try:
        yield
    finally:
        moe.route = route


def _greedy_and_consistency(device, cfg, model, params,
                            lengths=(GREEDY_PROMPT,), batch=1,
                            consist_params=None, **f32_changes):
    """(c) the loop's greedy tokens for a batch of ``batch`` prompts of
    each length == a manual greedy prefill and decode; (d) decode against
    a prefill cache == the longer prefill, f32 (``cfg`` with
    ``f32_changes``), full depth, on ``consist_params`` where given."""
    import numpy as np
    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.serve import Request, ServeLoop, grow_cache

    rng = np.random.default_rng(SEED + 140)
    greedy = {}
    for plen in lengths:
        prompts = rng.integers(0, cfg.vocab - 1, (batch, plen)).astype(
            np.int32)
        max_seq = plen + GREEDY_NEW + 15
        loop = ServeLoop(model, params, max_seq=max_seq, batch_slots=batch,
                         device=device)
        done = loop.run([Request(session=i, prompt=prompts[i],
                                 max_new_tokens=GREEDY_NEW)
                         for i in range(batch)])
        logits, cache = model.prefill(params, {"tokens": prompts})
        grown = grow_cache(model, cache, max_seq, batch)
        # leaves of constant size (SSM states, conv tails) are not padded
        kept = sum(a is b for a, b in zip(tree_leaves(cache),
                                          tree_leaves(grown)))
        if model.family == "ssm" and kept != len(tree_leaves(cache)):
            raise AssertionError(f"prompt of {plen}: an SSM cache grew")
        cache, want = grown, [[] for _ in range(batch)]
        for t in range(GREEDY_NEW):
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            for i, v in enumerate(nxt.tolist()):
                want[i].append(v)
            logits, cache = model.decode(params, cache, {
                "token": nxt[:, None], "pos": plen + t})
        got = [r.out_tokens for r in done]
        if got != want:
            raise AssertionError(f"prompts of {plen}: loop {got} != "
                                 f"manual {want}")
        greedy[plen] = {"tokens": want[0], "constant_leaves": kept}
    return {"greedy": greedy, **_consistency(
        device, cfg, params if consist_params is None else consist_params,
        rng, **f32_changes)}


def _consistency(device, cfg, params, rng, extra=None, hold=True,
                 **f32_changes):
    """Decode of token T against the cache of ``prompt[:T]`` == the
    prefill of ``prompt[:T+1]``, f32 (``cfg`` with ``f32_changes``),
    within 2e-2 (only reported unless ``hold``); an MoE config must drop
    no (token, expert) pair."""
    import dataclasses

    import torch

    from repro_torch.models import get_model
    from repro_torch.serve import grow_cache

    f32 = get_model(dataclasses.replace(cfg, dtype="float32", **f32_changes),
                    device)
    toks = rng.integers(0, cfg.vocab - 1, (CONSIST_B, CONSIST_T + 1))
    extra = extra or {}
    drops = []
    with _routes(lambda r: drops.append(int((r.rank >= r.capacity).sum()))):
        full, _ = f32.prefill(params, {"tokens": toks, **extra})
        _, cache = f32.prefill(params, {"tokens": toks[:, :CONSIST_T],
                                        **extra})
        dec, _ = f32.decode(params, grow_cache(f32, cache, CONSIST_T + 1,
                                               CONSIST_B),
                            {"token": toks[:, CONSIST_T:], "pos": CONSIST_T})
    err = float((dec - full).abs().max())
    if any(drops) or hold and not torch.allclose(dec, full, rtol=2e-2,
                                                 atol=2e-2):
        raise AssertionError(f"decode != prefill at full depth: {err}, "
                             f"drops {sum(drops)}")
    out = {"consistency_max_abs_err": err,
           "consistency_logit_max": float(full.abs().max())}
    if f32_changes:
        out["consistency_config"] = f32_changes
    return out


def _cut_depth(cfg, params, n_layers):
    """``cfg`` in f32 at ``n_layers`` (decoder) layers and ``params``
    with those layers' slices; every other leaf (the encoder, a hybrid's
    shared blocks) as it is."""
    import dataclasses

    from repro_torch.models.params import tree_map

    key = "dec_layers" if cfg.family == "encdec" else "layers"
    small = dataclasses.replace(cfg, n_layers=n_layers, dtype="float32")
    return small, dict(params, **{key: tree_map(lambda a: a[:n_layers],
                                                params[key])})


def _card_vs_cpu(device, cfg, params, layers=CARD_CPU_LAYERS, extra=None):
    """(e) the first ``layers`` layers of the card's weights at full width
    in f32, copied to the CPU (drawing them with the host's generator
    takes tens of seconds); prefill logits compared.  An MoE model's
    routing is compared first: a token whose top-k experts differ (a
    near-tie flipped by the order of f32 sums) is counted, and the
    logits are held to the tolerance on the sequences (one group each)
    whose routing agrees on every layer."""
    import numpy as np
    import torch

    from repro_torch.models import get_model
    from repro_torch.models.params import tree_leaves, tree_map

    small, p_card = _cut_depth(cfg, params, layers)
    t0 = time.perf_counter()
    p_cpu = tree_map(lambda a: a.cpu(), p_card)
    copy_s = time.perf_counter() - t0
    toks = np.random.default_rng(SEED + 141).integers(
        0, cfg.vocab - 1, (CONSIST_B, CONSIST_T))
    batch = {"tokens": toks, **(extra or {})}
    runs = []
    for dev, p in (("cpu", p_cpu), (device, p_card)):
        topi = []
        with _routes(lambda r: topi.append(r.topi.cpu())):
            logits, cache = get_model(small, dev).prefill(p, batch)
        runs.append((logits.cpu(), [c.cpu() for c in tree_leaves(cache)],
                     topi))
    (want, kv_cpu, topi_cpu), (got, kv_card, topi_card) = runs
    agree = torch.ones(CONSIST_B, dtype=torch.bool)
    flips = 0
    for a, b in zip(topi_cpu, topi_card):        # (B, T, K) a layer
        same = (a == b).all(-1)
        flips += int((~same).sum())
        agree &= same.all(-1)
    err = float((got - want)[agree].abs().max()) if agree.any() else None
    kv_err = max(float((a - b).abs().max()) for a, b in zip(kv_card, kv_cpu))
    if not agree.any() or not torch.allclose(
            got[agree], want[agree], rtol=CARD_CPU_TOL, atol=CARD_CPU_TOL):
        raise AssertionError(f"card != CPU: logits max_abs_err {err}, "
                             f"routing flips {flips}")
    out = {"layers": layers, "tolerance": CARD_CPU_TOL,
           "logits_max_abs_err": err, "cache_max_abs_err": kv_err,
           "logit_max": float(want.abs().max()), "copy_s": copy_s}
    if topi_cpu:
        out.update(routing_flips=flips, routed_tokens=CONSIST_B * CONSIST_T,
                   sequences_compared=int(agree.sum()))
    return out


def _paged_roundtrip(device, cfg, cache):
    """(f) batch 1's final cache through a PagedKVCache: each sequence's
    prompt by write_prefill, its decoded tokens by write_token, then
    gather_cache == the loop's cache, bit for bit."""
    import torch

    from repro_torch.serve import PagedKVCache

    k, v = cache                               # (L, B, max_seq, kv, hd)
    n = SERVE_PROMPT + SERVE_NEW
    pages = -(-n // PAGE_SIZE)
    pc = PagedKVCache(cfg.n_layers, SERVE_SLOTS * pages + 8, PAGE_SIZE,
                      cfg.kv_cache_heads, cfg.hd, dtype=k.dtype, device=device)
    for i in range(SERVE_SLOTS):
        pc.alloc_seq(i, SERVE_PROMPT)
        pc.write_prefill(i, k[:, i, :SERVE_PROMPT], v[:, i, :SERVE_PROMPT])
        for pos in range(SERVE_PROMPT, n):
            pc.write_token(i, pos, k[:, i, pos:pos + 1], v[:, i, pos:pos + 1])
    gk, gv = pc.gather_cache(list(range(SERVE_SLOTS)), pages)
    ok = (torch.equal(gk[:, :, :n], k[:, :, :n])
          and torch.equal(gv[:, :, :n], v[:, :, :n]))
    used = len(pc.free)
    for i in range(SERVE_SLOTS):
        pc.free_seq(i)
    if not ok or len(pc.free) != pc.n_pages or used != 8:
        raise AssertionError("paged KV cache round trip failed")
    return {"pages": pc.n_pages, "page_size": PAGE_SIZE,
            "dtype": str(pc.k.dtype),
            "pool_bytes": 2 * pc.k.numel() * pc.k.element_size(),
            "tokens": SERVE_SLOTS * n}


def phase_serve(device, kernels, smi):
    """Phase 14, each part printing its line; returns the serve run's
    numbers."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t_phase = t0 = time.perf_counter()
        cfg, model, params, made = _serve_model(device, SERVE_ARCH,
                                                SERVE_BAND)
        if torch.device(device).type == "cuda":
            made["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        print(f"[14/17] (a) {SERVE_ARCH} at full width ({cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads, "
              f"{cfg.n_kv_heads} KV heads, vocab {cfg.vocab}), f32 params "
              f"on the card, count_params == leaves in {SERVE_BAND}: "
              f"{json.dumps(made)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        serve, batch1, prompts = _serve_loop(device, kernels, cfg, model,
                                             params)
        serve["profile"] = _serve_profile(device, model, params, batch1,
                                          prompts, SERVE_PROMPT + SERVE_NEW)
        print(f"[14/17] (b) ServeLoop(max_seq={SERVE_MAX_SEQ}, batch_slots="
              f"{SERVE_SLOTS}, prefix_chunk={SERVE_CHUNK}), 8 greedy "
              f"requests (sessions 0-3 twice, {SERVE_PROMPT}-token prompts, "
              f"{SERVE_NEW} new tokens): index answers and stats == the CPU "
              f"twin, one B6 launch a lookup against a segment, none "
              f"before, B1 for the segments' rows, no other launch (profile: "
              f"a decode step and a prefill, device time by torch.profiler): "
              f"{json.dumps(serve)} on {smi} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        greedy = _greedy_and_consistency(device, cfg, model, params)
        print(f"[14/17] (c, d) loop greedy tokens == manual greedy decode; "
              f"decode(token T | cache(prompt[:T])) == prefill(prompt[:T+1])"
              f" within 2e-2 at full depth, f32, B {CONSIST_B}, T "
              f"{CONSIST_T}: {json.dumps(greedy)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        versus = _card_vs_cpu(device, cfg, params)
        print(f"[14/17] (e) card == CPU, {CARD_CPU_LAYERS} layers at full "
              f"width, f32, TF32 off, prefill logits within {CARD_CPU_TOL}: "
              f"{json.dumps(versus)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        paged = _paged_roundtrip(device, cfg, batch1)
        if torch.device(device).type == "cuda":
            serve["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        secs = time.perf_counter() - t_phase
        print(f"[14/17] (f) PagedKVCache at the full KV shape == the loop's "
              f"cache bit for bit: {json.dumps(paged)}; phase 14 in "
              f"{secs:.1f} s on {smi}", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return dict(serve, phase_s=secs)


# ---------------------------------------------------------------------------
# phase 15: the MoE, SSM, hybrid and encoder-decoder families
# ---------------------------------------------------------------------------

#: tests/test_models.py's parameter bands, where it has one
FAMILY_BANDS = {"mamba2-130m": (0.1e9, 0.2e9),
                "zamba2-2.7b": (2.2e9, 3.5e9),
                "whisper-base": (0.05e9, 0.12e9)}
FAMILY_NEW = 16               # new tokens a request (phase 14: 32)
HYBRID_CARD_CPU_LAYERS = 6    # zamba2: one attention application
WHISPER_B, WHISPER_T = 4, 64  # sequences of 1,500 frames; prompt tokens
MOONSHOT_LAYERS = 4           # of 48: its 28.06 B f32 params need 112 GB
SSD_B, SSD_S = 4, 256         # ssd_chunked at mamba2-130m's shapes
SSD_TOL = 1e-4


def _tamed(params):
    """``params`` with every 3-D attention projection rescaled from the
    reference's init fan-in to the true one (ROADMAP C.8): ``wq`` /
    ``wk`` / ``wv`` (..., D, H, hd) were drawn at 1/sqrt(H), ``wo``
    (..., H, hd, D) at 1/sqrt(hd).  At those scales a layer without
    qk-norm has attention logits of standard deviation near D/H (64 on
    granite-moe), its softmax picks one key, and f32 roundings grow from
    layer to layer; rescaled, the precision checks compare the code, not
    that amplification.  Other leaves are shared."""
    import math

    def walk(t):
        if not isinstance(t, dict):
            return t
        out = {}
        for k, v in t.items():
            if k in ("wq", "wk", "wv") and not isinstance(v, dict):
                out[k] = v * math.sqrt(v.shape[-2] / v.shape[-3])
            elif k == "wo" and not isinstance(v, dict):
                out[k] = v / math.sqrt(v.shape[-3])
            else:
                out[k] = walk(v)
        return out
    return walk(params)


def _peak(device):
    import torch

    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated()


def _free(device):
    """Release a finished part's tensors and reset the peak count."""
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _no_drop(cfg) -> dict:
    """The capacity factor at which every (token, expert) pair keeps its
    slot (C = Sg): a prefill of T + 1 tokens forms other groups, hence
    other drops, than one of T, so decode == prefill holds only there."""
    return ({"moe_capacity_factor": cfg.n_experts / cfg.experts_per_token}
            if cfg.family == "moe" else {})


def _served_family(device, kernels, smi, part, arch, card_cpu_layers,
                   lengths=(GREEDY_PROMPT,)):
    """Phase 15 (a)-(c): ``arch`` at full width served as phase 14 serves
    qwen3 (FAMILY_NEW new tokens), each check printing its line; returns
    the serve run's numbers."""
    import numpy as np

    t_part = t0 = time.perf_counter()
    cfg, model, params, made = _serve_model(device, arch,
                                            FAMILY_BANDS.get(arch))
    made["max_memory_allocated"] = _peak(device)
    print(f"[15/17] ({part}) {arch} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}), f32 params on the "
          f"card: {json.dumps(made)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    t0 = time.perf_counter()
    drops = []

    def count_drops(r):      # the served prefills' groups (decode: Sg 1)
        if r.rank.shape[1] > 1:
            drops.append((int((r.rank >= r.capacity).sum()), r.rank.numel()))

    with _routes(count_drops):
        serve, batch1, prompts = _serve_loop(device, kernels, cfg, model,
                                             params, new=FAMILY_NEW)
    if drops:
        serve["capacity_dropped_share"] = sum(d for d, _ in drops) / sum(
            n for _, n in drops)
    serve["profile"] = _serve_profile(device, model, params, batch1,
                                      prompts, SERVE_PROMPT + FAMILY_NEW)
    print(f"[15/17] ({part}) ServeLoop as phase 14's, {FAMILY_NEW} new "
          f"tokens: index answers and stats == the CPU twin, one B6 launch "
          f"a lookup against a segment, none before, B1 for the segments' "
          f"rows, no other launch: {json.dumps(serve)} on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del batch1
    t0 = time.perf_counter()
    tamed = _tamed(params)
    greedy = _greedy_and_consistency(device, cfg, model, params, lengths,
                                     SERVE_SLOTS, tamed, **_no_drop(cfg))
    greedy["reference_init"] = _consistency(
        device, cfg, params, np.random.default_rng(SEED + 143), hold=False,
        **_no_drop(cfg))
    print(f"[15/17] ({part}) loop greedy tokens == manual greedy decode for "
          f"{SERVE_SLOTS} prompts of each of {list(lengths)} tokens; "
          f"decode == prefill within 2e-2 at full depth, f32, attention "
          f"projections at their true fan-in (ROADMAP C.8; at the "
          f"reference's init the gap is reported, not held; an MoE at the "
          f"capacity factor that drops nothing): {json.dumps(greedy)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    versus = _card_vs_cpu(device, cfg, tamed, card_cpu_layers)
    print(f"[15/17] ({part}) card == CPU, {card_cpu_layers} layers at full "
          f"width, f32, TF32 off, prefill logits within {CARD_CPU_TOL}: "
          f"{json.dumps(versus)} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    serve["max_memory_allocated"] = _peak(device)
    serve["part_s"] = time.perf_counter() - t_part
    del model, params, tamed
    _free(device)
    return serve


def _ssd_on_card(device, cfg):
    """(b) ``ssd_chunked`` at ``cfg``'s heads, state and chunk (B SSD_B,
    S SSD_S: two chunks) against the naive recurrence in f64, f32."""
    import numpy as np
    import torch

    from repro_torch.models.mamba2 import ssd_chunked

    rng = np.random.default_rng(SEED + 150)
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    f = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    x = f(rng.normal(0, 1, (SSD_B, SSD_S, H, Pd)))
    dt = f(rng.uniform(0.01, 0.2, (SSD_B, SSD_S, H)))
    A = -f(rng.uniform(0.5, 2, H))
    Bm = f(rng.normal(0, 1, (SSD_B, SSD_S, N)))
    Cm = f(rng.normal(0, 1, (SSD_B, SSD_S, N)))
    t0 = time.perf_counter()
    y, state = ssd_chunked(x, dt, A, Bm, Cm, cfg.ssm_chunk)
    _sync(device)
    ssd_s = time.perf_counter() - t0
    d = [t.double() for t in (x, dt, A, Bm, Cm)]
    s = torch.zeros((SSD_B, H, N, Pd), dtype=torch.float64, device=device)
    ys = []
    for t in range(SSD_S):
        s = torch.exp(d[1][:, t] * d[2])[:, :, None, None] * s + \
            torch.einsum("bh,bn,bhp->bhnp", d[1][:, t], d[3][:, t],
                         d[0][:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", d[4][:, t], s))
    naive = torch.stack(ys, dim=1)
    err = float((y.double() - naive).abs().max())
    s_err = float((state.double() - s).abs().max())
    if not (torch.allclose(y.double(), naive, atol=SSD_TOL, rtol=SSD_TOL)
            and torch.allclose(state.double(), s, atol=SSD_TOL,
                               rtol=SSD_TOL)):
        raise AssertionError(f"ssd_chunked != naive: y {err}, state {s_err}")
    return {"shape": [SSD_B, SSD_S, H, Pd], "state": N,
            "chunk": cfg.ssm_chunk, "tolerance": SSD_TOL,
            "y_max_abs_err": err, "y_max": float(naive.abs().max()),
            "state_max_abs_err": s_err, "ssd_s": ssd_s}


def _whisper(device, smi):
    """Phase 15 (d): whisper-base at full width, not served (the loop
    passes no frames): a prefill of WHISPER_T tokens over WHISPER_B
    sequences of 1,500 frame embeddings, FAMILY_NEW greedy decode steps,
    decode == prefill in f32, card == CPU at full depth."""
    import numpy as np
    import torch

    from repro_torch.serve import grow_cache

    t_part = time.perf_counter()
    arch = "whisper-base"
    cfg, model, params, made = _serve_model(device, arch, FAMILY_BANDS[arch])
    rng = np.random.default_rng(SEED + 154)
    frames = rng.normal(0, 1, (WHISPER_B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab - 1, (WHISPER_B, WHISPER_T))
    pre_s, dec_s = [], []
    prefill = _timed(model.prefill, pre_s, device)
    decode = _timed(model.decode, dec_s, device)
    logits, cache = prefill(params, {"frames": frames, "tokens": toks})
    cache = grow_cache(model, cache, WHISPER_T + FAMILY_NEW, WHISPER_B)
    if cache["xk"].shape[2] != cfg.enc_seq:
        raise AssertionError(f"cross-attention KV grew: {cache['xk'].shape}")
    out = []
    for t in range(FAMILY_NEW):
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        out.append(nxt)
        logits, cache = decode(params, cache, {"token": nxt[:, None],
                                               "pos": WHISPER_T + t})
    tokens = torch.stack(out, 1).tolist()
    if not (torch.isfinite(logits).all() and all(
            0 <= t < cfg.vocab for r in tokens for t in r)):
        raise AssertionError("whisper decode: non-finite logits or a token "
                             "outside the vocab")
    token = torch.zeros((WHISPER_B, 1), dtype=torch.int32, device=device)
    run = {"prefill_s": pre_s, "decode_steps": len(dec_s),
           "prefill_tokens_per_s": WHISPER_B * WHISPER_T / sum(pre_s),
           "prefill_frames_per_s": WHISPER_B * cfg.enc_seq / sum(pre_s),
           "decode_steps_per_s": len(dec_s) / sum(dec_s),
           "decode_tokens_per_s": len(dec_s) * WHISPER_B / sum(dec_s),
           "decode_step_ms_median": 1e3 * float(np.median(dec_s)),
           "tokens": tokens[0],
           "profile": {"decode_step": _device_busy(lambda: model.decode(
               params, cache, {"token": token,
                               "pos": WHISPER_T + FAMILY_NEW - 1})),
               "prefill": _device_busy(lambda: model.prefill(
                   params, {"frames": frames, "tokens": toks}), reps=2)}}
    del cache
    few = {"frames": frames[:CONSIST_B]}
    tamed = _tamed(params)
    run.update(_consistency(device, cfg, tamed, rng, few))
    run["reference_init"] = _consistency(device, cfg, params, rng, few,
                                         hold=False)
    run["card_vs_cpu"] = _card_vs_cpu(device, cfg, tamed, cfg.n_layers, few)
    made["max_memory_allocated"] = _peak(device)
    print(f"[15/17] (d) {arch} at full width ({cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.enc_seq} "
          f"frames, vocab {cfg.vocab}), f32 params on the card: "
          f"{json.dumps(made)}; prefill of {WHISPER_B} x {WHISPER_T} tokens, "
          f"{FAMILY_NEW} greedy decode steps, decode == prefill within 2e-2 "
          f"(f32), card == CPU at full depth within {CARD_CPU_TOL}, both on "
          f"attention projections at their true fan-in (ROADMAP C.8): "
          f"{json.dumps(run)} on {smi} "
          f"({time.perf_counter() - t_part:.1f} s)", flush=True)
    del model, params, tamed
    _free(device)
    return run


def _moonshot(device, smi):
    """Phase 15 (e): moonshot-v1-16b-a3b at full width cut to
    MOONSHOT_LAYERS layers: decode == prefill at the no-drop capacity."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config

    t_part = time.perf_counter()
    full = get_config("moonshot-v1-16b-a3b")
    cfg, model, params, made = _serve_model(
        device, full.name, None,
        dataclasses.replace(full, n_layers=MOONSHOT_LAYERS))
    made["max_memory_allocated"] = _peak(device)
    rng = np.random.default_rng(SEED + 155)
    consist = _consistency(device, cfg, _tamed(params), rng, **_no_drop(cfg))
    consist["reference_init"] = _consistency(device, cfg, params, rng,
                                             hold=False, **_no_drop(cfg))
    print(f"[15/17] (e) {full.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts, top-{cfg.experts_per_token}, vocab "
          f"{cfg.vocab}) cut to {MOONSHOT_LAYERS} of {full.n_layers} "
          f"layers, f32 params on the card: {json.dumps(made)}; decode == "
          f"prefill within 2e-2 (f32, nothing dropped, attention projections "
          f"at their true fan-in, ROADMAP C.8): "
          f"{json.dumps(consist)} on {smi} "
          f"({time.perf_counter() - t_part:.1f} s)", flush=True)
    del model, params
    _free(device)
    return consist


def phase_families(device, kernels, smi):
    """Phase 15: granite-moe-3b-a800m, mamba2-130m and zamba2-2.7b served
    at full width, whisper-base driven, moonshot at full width cut in
    depth; returns each served part's numbers."""
    import torch

    from repro_torch.configs import get_config

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    try:
        _free(device)
        served = {"granite-moe-3b-a800m": _served_family(
            device, kernels, smi, "a", "granite-moe-3b-a800m",
            CARD_CPU_LAYERS)}
        mamba = get_config("mamba2-130m")
        t0 = time.perf_counter()
        ssd = _ssd_on_card(device, mamba)
        print(f"[15/17] (b) ssd_chunked on the card == the naive recurrence "
              f"(f64) within {SSD_TOL}, f32: {json.dumps(ssd)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        served["mamba2-130m"] = _served_family(
            device, kernels, smi, "b", "mamba2-130m", mamba.n_layers,
            (GREEDY_PROMPT, mamba.ssm_heads, mamba.conv_kernel - 1))
        zamba = get_config("zamba2-2.7b")
        served["zamba2-2.7b"] = _served_family(
            device, kernels, smi, "c", "zamba2-2.7b", HYBRID_CARD_CPU_LAYERS,
            (GREEDY_PROMPT, zamba.conv_kernel - 1))
        whisper = _whisper(device, smi)
        moonshot = _moonshot(device, smi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    secs = time.perf_counter() - t_phase
    launches = {k: sum(s["launches"].get(k, 0) for s in served.values())
                for k in ("point_stacked", "insert")}
    print(f"[15/17] phase 15 in {secs:.1f} s on {smi}: launches "
          f"{json.dumps(launches)}", flush=True)
    return {"served": served, "whisper": whisper, "moonshot": moonshot,
            "launches": launches, "phase_s": secs}


# ---------------------------------------------------------------------------
# phase 16: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_B, TRAIN_S = 4, 512     # examples/train_lm_dedup.py's batch, 512 tokens
TRAIN_STEPS = 8
TRAIN_MB = 2                  # microbatches of 2 sequences
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=8)
DEDUP_DOCS = 1 << 14          # StreamDeduper(expected_docs), the example's
TRAIN_WINDOW = (0, 10_000)    # the example's freshness window
MEMO_STEPS = 6                # (b) one repeated batch
#: (c) the reference tests' train steps: (arch, microbatches, int8 EF)
SMOKE_STEPS = (("qwen3-1.7b", 1, False), ("granite-moe-3b-a800m", 2, True),
               ("zamba2-2.7b", 1, False), ("whisper-base", 1, False))
STEP_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
#: card against CPU, f32 with TF32 off: loss, grad norm and the step's
#: clipped gradient (read from Adam's first moment) within 1e-4 of their
#: scale; the params within 1e-4 where that gradient is resolved
#: (|g| > RESOLVED).  Below it rounding noise (~1e-8) is of the order of
#: Adam's eps and decides the sign of the first update g / (|g| + eps),
#: so there the params are held to the bound of any Adam step,
#: lr (1 + wd |p|) on each side
STEP_TOL = 1e-4
RESOLVED = 1e-5
LAYER_TOL = 1e-5              # rmsnorm and flash Functions, card vs CPU, f32
FLASH_FULL = (1, 2048, 8, 2, 128)   # qwen3-1.7b's heads: B, S, Hkv, G, hd
FLASH_BF16_TOL = 2e-2         # bf16 grads against f32 autograd, of scale
RESTART_ARCH = "qwen2.5-3b"   # tests/test_train.py's restart test
RESTART_STEPS, RESTART_EVERY, RESTART_FAIL = 14, 7, 10


def _seeded_batch(cfg, seed, B, S):
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab - 1, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, cfg.d_model)
                                     ).astype(np.float32)
    return batch


def _samples(params) -> list:
    """A strided sample of up to 4,096 elements of every leaf."""
    from repro_torch.models.params import tree_leaves

    return [a.detach().reshape(-1)[::max(1, a.numel() // 4096)].clone()
            for a in tree_leaves(params)]


def _corpus(cfg):
    from repro_torch.data import SyntheticCorpus

    return SyntheticCorpus(vocab=cfg.vocab, seed=1, dup_rate=0.3)


def _stream(cfg, deduper, device):
    from repro_torch.data import batch_iterator

    return batch_iterator(_corpus(cfg), TRAIN_B, TRAIN_S, deduper=deduper,
                          window=TRAIN_WINDOW, device=device)


def _stream_twin(cfg, steps):
    """The stream on the CPU: its batches' tokens, the deduper's stats
    and the kept count of each admitted shard."""
    from repro_torch.data import StreamDeduper

    twin = StreamDeduper(DEDUP_DOCS, device="cpu")
    admit, kept = twin.admit, []

    def counted(ids):
        keep = admit(ids)
        kept.append(int(keep.sum()))
        return keep

    twin.admit = counted
    it = _stream(cfg, twin, "cpu")
    tokens = [next(it)["tokens"].numpy() for _ in range(steps)]
    return tokens, dict(twin.stats), kept


def _train_tflop(cfg, model) -> float:
    """A step's matrix-product TFLOP from the shapes: the forward's 2
    FLOP a token a matmul weight (every param but the embedding, a
    gather) and its attention scores and sums (4 B S^2 H hd a layer,
    the causal half included, as the scan computes it), three times
    (forward and a backward of twice its work), plus the layers'
    forward again (remat)."""
    from repro_torch.models.params import count_params

    table = model.table()
    mm = count_params(table) - count_params({"e": table["embed"]})
    layers = count_params(table["layers"])
    tokens = TRAIN_B * TRAIN_S
    attn = 4 * TRAIN_B * TRAIN_S ** 2 * cfg.n_heads * cfg.hd * cfg.n_layers
    fwd, fwd_layers = 2 * tokens * mm + attn, 2 * tokens * layers + attn
    return (3 * fwd + fwd_layers) / 1e12


def _train_full(device, kernels, smi):
    """(a) the deduped stream into full-width qwen3-1.7b: 8 steps of 2
    microbatches with int8 error feedback; returns the numbers and the
    first batch."""
    import math

    import numpy as np
    import torch

    from repro_torch.core.layout import basic_layout
    from repro_torch.data import StreamDeduper
    from repro_torch.train import OptConfig, TrainConfig, Trainer, cosine_lr

    t0 = time.perf_counter()
    _free(device)
    cfg, model, params, made = _serve_model(device, TRAIN_ARCH, SERVE_BAND)
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name}: remat {cfg.remat}, {cfg.dtype}")
    before = _samples(params)
    deduper = StreamDeduper(DEDUP_DOCS, device=device)
    seen = []

    def recorded(it):
        for b in it:
            seen.append(b)
            yield b

    opt = OptConfig(**TRAIN_OPT)
    tr = Trainer(model, params, opt,
                 TrainConfig(steps=TRAIN_STEPS, microbatches=TRAIN_MB,
                             grad_compression=True, log_every=1,
                             checkpoint_every=1 << 30),
                 recorded(_stream(cfg, deduper, device)))
    read = _counted(kernels)
    t_run = time.perf_counter()
    log = tr.run()
    run_s = time.perf_counter() - t_run
    launches = read()
    peak = _peak(device)

    tokens, stats, kept = _stream_twin(cfg, TRAIN_STEPS)
    if dict(deduper.stats) != stats or any(
            not np.array_equal(b["tokens"].cpu().numpy(), t)
            for b, t in zip(seen, tokens)) or len(seen) != TRAIN_STEPS:
        raise AssertionError(f"stream != CPU twin: stats {deduper.stats} "
                             f"vs {stats}")
    corpus = _corpus(cfg)
    shards = corpus.n_shards        # ShardRangeIndex: a filter a shard
    index = basic_layout(32, corpus.docs_per_shard, 12.0, delta=6)
    expect = {k: 0 for k in kernels}
    expect.update(insert=shards + sum(k > 0 for k in kept),
                  point=len(kept),
                  range=0 if index.has_exact else shards)
    if launches != expect:
        raise AssertionError(f"train data launches {launches} (expected "
                             f"{expect})")
    for r in log:
        want = float(cosine_lr(opt, torch.tensor(r["step"] + 1,
                                                 dtype=torch.int32,
                                                 device=device)))
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["lr"] == want):
            raise AssertionError(f"step {r}: lr {want}")
        if abs(r["lr"] - float(cosine_lr(opt, r["step"] + 1))) > \
                1e-6 * r["lr"]:
            raise AssertionError(f"step {r}: CPU schedule differs")
    moved = [bool((a != b).any()) for a, b in zip(before,
                                                   _samples(tr.params))]
    if not all(moved):
        raise AssertionError(f"{moved.count(False)} leaves did not move")
    times = [r["step_time_s"] for r in log]
    batch = seen[-1]
    busy = (_device_busy(lambda: tr.step_fn(tr.params, tr.opt_state,
                                            tr.ef_error, batch), reps=1,
                         top=8)
            if torch.device(device).type == "cuda" else None)
    info = {
        **made, "remat": cfg.remat, "activations": cfg.dtype,
        "batch": [TRAIN_B, TRAIN_S], "microbatches": TRAIN_MB,
        "grad_compression": True, "steps": TRAIN_STEPS,
        "losses": [r["loss"] for r in log],
        "grad_norms": [r["grad_norm"] for r in log],
        "lrs": [r["lr"] for r in log],
        "step_ms": [1e3 * t for t in times],
        "step_ms_median": 1e3 * float(np.median(times[1:])),
        "tokens_per_s": TRAIN_B * TRAIN_S / float(np.median(times[1:])),
        "matmul_tflop_per_step": _train_tflop(cfg, model),
        "matmul_ms_at_bf16_peak": _train_tflop(cfg, model) / 989 * 1e3,
        "dedup_stats": stats, "shards_admitted_batches": len(kept),
        "launches": {k: v for k, v in launches.items() if v},
        "step_profile": busy,
        # the profiler's own cost inflates the traced wall time: the
        # device's share of an untraced median step
        "device_share_of_median_step": (
            busy["device_ms"] / (1e3 * float(np.median(times[1:])))
            if busy else None),
        "max_memory_allocated": peak,
        "card_memory": (torch.cuda.get_device_properties(0).total_memory
                        if torch.device(device).type == "cuda" else None),
        "run_s": run_s, "part_s": time.perf_counter() - t0}
    print(f"[16/17] (a) {TRAIN_ARCH} at full width ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, remat, bf16 activations, f32 params) "
          f"trained {TRAIN_STEPS} steps on the deduped stream (batch "
          f"{TRAIN_B} x {TRAIN_S}, {TRAIN_MB} microbatches, int8 error "
          f"feedback): losses and grad norms finite, lr == cosine_lr, every "
          f"leaf moved, stream == the CPU twin, B1/B2/B3 as the data path "
          f"implies: {json.dumps(info)} on {smi}", flush=True)
    return info, seen[0]


def _train_memorize(device, batch):
    """(b) 6 steps on one repeated batch from a fresh init (the same draw
    as (a)'s): the last loss below the first."""
    import itertools

    from repro_torch.train import OptConfig, TrainConfig, Trainer

    t0 = time.perf_counter()
    _free(device)
    _, model, params, _ = _serve_model(device, TRAIN_ARCH, SERVE_BAND)
    tr = Trainer(model, params, OptConfig(lr=TRAIN_OPT["lr"], warmup_steps=1,
                                          total_steps=MEMO_STEPS),
                 TrainConfig(steps=MEMO_STEPS, log_every=1,
                             checkpoint_every=1 << 30),
                 itertools.repeat(batch))
    losses = [r["loss"] for r in tr.run()]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"memorization: losses {losses}")
    return {"steps": MEMO_STEPS, "microbatches": 1, "losses": losses,
            "step_ms": [1e3 * r["step_time_s"] for r in tr.metrics_log],
            "max_memory_allocated": _peak(device),
            "part_s": time.perf_counter() - t0}


def _held_step(ours, ref, lr, ef):
    """One train step's result ``ours`` against ``ref`` (each ``(params
    before, params, first moments, metrics)``, numpy leaves): STEP_TOL's
    rule.  Returns the worst errors."""
    import numpy as np

    wd = 0.1
    out = {"loss_rel": abs(ours[3]["loss"] - ref[3]["loss"]) /
           abs(ref[3]["loss"]),
           "grad_norm_rel": abs(ours[3]["grad_norm"] - ref[3]["grad_norm"])
           / ref[3]["grad_norm"], "grad_err_of_scale": 0.0,
           "param_err_resolved": 0.0, "unresolved_over_tol": 0}
    if max(out["loss_rel"], out["grad_norm_rel"]) > STEP_TOL:
        raise AssertionError(f"train step: {out}")
    for p0, pa, ma, pb, mb in zip(ref[0], ours[1], ours[2], ref[1], ref[2]):
        ga, gb = ma / 0.1, mb / 0.1
        scale = float(np.abs(gb).max())
        gerr = float(np.abs(ga - gb).max())
        quantum = scale / 127 if ef else 0.0
        if gerr > STEP_TOL * scale + quantum * (1 + 1e-3):
            raise AssertionError(f"train step gradient: {gerr} of {scale}")
        d = np.abs(pa - pb)
        resolved = np.abs(gb) > RESOLVED
        if (d[resolved] > STEP_TOL).any() or (
                d > 2 * lr * (1 + wd * np.abs(p0)) + STEP_TOL).any():
            raise AssertionError(f"train step params: {float(d.max())}")
        out["grad_err_of_scale"] = max(out["grad_err_of_scale"],
                                       gerr / max(scale, 1e-30))
        if resolved.any():
            out["param_err_resolved"] = max(out["param_err_resolved"],
                                            float(d[resolved].max()))
        out["unresolved_over_tol"] += int((d[~resolved] > STEP_TOL).sum())
    return out


def _grads_of(fn, inputs, dout):
    import torch

    xs = [x.detach().clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    return [out.detach()] + list(torch.autograd.grad(out, xs, dout))


def _of_scale(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max()) / max(
        1.0, float(b.float().abs().max()))


def _train_card_vs_cpu(device):
    """(c) one train step of each smoke family on the card == the CPU
    (f32, TF32 off, attention at the true fan-in); the rmsnorm and flash
    Functions on the card == the CPU; flash backward at qwen3-1.7b's head
    shapes in bf16 against f32 autograd of the plain forward."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.compression import ef_init
    from repro_torch.models import get_model, layers
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (OptConfig, TrainConfig, adamw_init,
                                   make_train_step)

    out = {"steps": {}}
    for arch, mb, ef in SMOKE_STEPS:
        cfg = get_config(arch, smoke=True)
        base = _tamed(get_model(cfg, "cpu").init(
            torch.Generator().manual_seed(SEED)))
        batch = _seeded_batch(cfg, SEED + 160, 4, 16)
        runs = []
        for dev in ("cpu", device):
            p = tree_map(lambda a: a.clone().to(dev), base)
            step = make_train_step(get_model(cfg, dev), OptConfig(**STEP_OPT),
                                   TrainConfig(steps=1, microbatches=mb,
                                               grad_compression=ef))
            p, o, _, m = step(p, adamw_init(p), ef_init(p) if ef else {},
                              batch)
            runs.append(([a.numpy() for a in tree_leaves(base)],
                         [a.cpu().numpy() for a in tree_leaves(p)],
                         [a.cpu().numpy() for a in tree_leaves(o["m"])],
                         {k: float(v) for k, v in m.items()}))
        out["steps"][arch] = dict(
            _held_step(runs[1], runs[0], runs[0][3]["lr"], ef),
            microbatches=mb, grad_compression=ef, loss=runs[1][3]["loss"])

    rng = np.random.default_rng(SEED + 161)

    def pair(*shape):
        a = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
        return a, a.to(device)

    x, xd = pair(4, 64, 256)
    w, wd = pair(256)
    dy, dyd = pair(4, 64, 256)
    norm = [_of_scale(a, b) for a, b in zip(
        _grads_of(lambda a, b: layers.rmsnorm(a, b, 1e-6), (xd, wd), dyd),
        _grads_of(lambda a, b: layers.rmsnorm(a, b, 1e-6), (x, w), dy))]
    flash = {}
    for causal, off, skv in ((True, 0, 96), (False, 0, 100), (True, 8, 88)):
        q, qd = pair(2, 80, 2, 2, 64)
        k, kd = pair(2, skv, 2, 64)
        v, vd = pair(2, skv, 2, 64)
        do, dod = pair(2, 80, 2, 2, 64)
        fn = functools.partial(_flash_fn, causal=causal, q_offset=off)
        flash[f"causal{int(causal)}_off{off}_skv{skv}"] = [
            _of_scale(a, b) for a, b in zip(
                _grads_of(fn, (qd, kd, vd), dod), _grads_of(fn, (q, k, v), do))]
    errs = norm + [e for v in flash.values() for e in v]
    if max(errs) > LAYER_TOL:
        raise AssertionError(f"layer Functions card != CPU: {norm} {flash}")
    out.update(rmsnorm_err_of_scale=max(norm), flash_err_of_scale=flash)

    B, S, Hkv, G, hd = FLASH_FULL
    gen = torch.Generator(device).manual_seed(SEED + 162)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v, do = (draw(B, S, Hkv, G, hd), draw(B, S, Hkv, hd),
                   draw(B, S, Hkv, hd), draw(B, S, Hkv, G, hd))

    def plain(q, k, v):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(hd)
        keep = torch.ones(S, S, dtype=torch.bool, device=device).tril()
        p = torch.softmax(s.masked_fill(~keep, -math.inf), -1)
        return torch.einsum("bhgqk,bkhd->bqhgd", p, v)

    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    want = _grads_of(plain, [t.float() for t in bf[:3]], bf[3].float())
    fn = functools.partial(_flash_fn, causal=True, q_offset=0)
    got = _grads_of(fn, bf[:3], bf[3])
    full = [_of_scale(a, b) for a, b in zip(got, want)]
    if max(full) > FLASH_BF16_TOL or any(g.dtype != torch.bfloat16
                                         for g in got):
        raise AssertionError(f"bf16 flash backward at full width: {full}")
    out["flash_full_width_bf16"] = {
        "shape": list(FLASH_FULL), "err_of_scale": dict(zip(
            ("out", "dq", "dk", "dv"), full)),
        "tolerance": FLASH_BF16_TOL}
    if torch.device(device).type == "cuda":
        xs = [t.detach().requires_grad_() for t in bf[:3]]
        out["flash_full_width_bf16"]["fwd_bwd_ms"] = _cuda_ms(
            lambda: torch.autograd.grad(fn(*xs), xs, bf[3]), 5)
    return out


def _flash_fn(q, k, v, *, causal, q_offset):
    from repro_torch.models import layers

    return layers.flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def _train_restart(device, kernels):
    """(d) tests/test_train.py's restart test on the card: qwen2.5-3b
    smoke, 14 steps, a checkpoint every 7, a failure injected at step 10
    under a Supervisor; then a layer-range restore of its checkpoint."""
    import itertools

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.layout import basic_layout
    from repro_torch.models import get_model
    from repro_torch.models.params import tree_map
    from repro_torch.train import (OptConfig, TrainConfig, Trainer,
                                   latest_step, restore_checkpoint,
                                   restore_layer_range)
    from repro_torch.train.checkpoint import _flatten
    from repro_torch.train.fault_tolerance import Supervisor

    cfg = get_config(RESTART_ARCH, smoke=True)
    model = get_model(cfg, device)
    # the true attention fan-in (C.8): at the reference's, a rounding of
    # the card's nondeterministic sums grows from step to step (C.9)
    base = _tamed(model.init(torch.Generator(device).manual_seed(SEED)))
    batch = _seeded_batch(cfg, SEED + 163, 4, 32)

    def make(ckpt, fail=None):
        return Trainer(model, tree_map(torch.clone, base),
                       OptConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                       TrainConfig(steps=RESTART_STEPS,
                                   checkpoint_every=RESTART_EVERY,
                                   log_every=1),
                       itertools.repeat(batch), ckpt_dir=ckpt,
                       fail_at_step=fail)

    with tempfile.TemporaryDirectory() as tmp:
        read = _counted(kernels)
        straight = make(f"{tmp}/straight").run()
        b1_straight = read()["insert"]
        ckpt, sleeps = f"{tmp}/supervised", []
        sup = Supervisor(lambda: make(ckpt, RESTART_FAIL if latest_step(
            ckpt) is None else None), max_restarts=2, sleep=sleeps.append)
        read = _counted(kernels)
        res = sup.run()
        b1_supervised = read()["insert"]
        last = latest_step(ckpt)
        with open(f"{ckpt}/step_{last:06d}/manifest.json") as fh:
            manifest = json.load(fh)
        read = _counted(kernels)
        part, probed, loaded = restore_layer_range(ckpt, last, 1, 1,
                                                   device=device)
        b3 = read()["range"]
        full = restore_checkpoint(ckpt, last, {
            "params": base, "opt": {"m": base, "v": base,
                                    "count": torch.zeros(())}})
    saves = 2          # steps 6 and 13 in either run
    n_shards = manifest["n_shards"]
    hashed = sum(not basic_layout(m["domain_bits"], m["n_keys"],
                                  m["bits_per_key"],
                                  delta=m["delta"]).has_exact
                 for m in manifest["filters"])
    flat = _flatten(full)
    exact = all(v.shape[0] == 1 and np.array_equal(
        v, flat[k][1:2]) for k, v in part.items())
    rel = abs(res["metrics"][-1]["loss"] - straight[-1]["loss"]) / \
        straight[-1]["loss"]
    layered = sum(m["layered"] for m in manifest["leaves"].values())
    if (res["restarts"] != 1 or rel > STEP_TOL or len(sleeps) != 1
            or b1_straight != saves * n_shards
            or b1_supervised != saves * n_shards or b3 != hashed
            or not exact or len(part) != layered):
        raise AssertionError(f"restart: restarts {res['restarts']}, loss "
                             f"rel {rel}, B1 {b1_straight}/{b1_supervised}, "
                             f"B3 {b3} (hashed shards {hashed}), layer "
                             f"range exact {exact}, {len(part)} leaves")
    return {"restarts": res["restarts"], "final_loss": res["metrics"][-1][
        "loss"], "straight_final_loss": straight[-1]["loss"],
        "loss_rel": rel, "incidents": [i["error"] for i in res["incidents"]],
        "b1_checkpoint_launches": b1_straight + b1_supervised,
        "checkpoint_saves": 2 * saves, "shards": n_shards,
        "layer_range": {"layers": [1, 1], "leaves": len(part),
                        "probed": probed, "loaded": loaded,
                        "b3_launches": b3}}


def phase_train(device, kernels, smi):
    """Phase 16, each part printing its line; returns its launches and
    seconds."""
    import torch

    t_phase = time.perf_counter()
    full, first = _train_full(device, kernels, smi)
    memo = _train_memorize(device, first)
    print(f"[16/17] (b) {MEMO_STEPS} steps on one repeated batch at full "
          f"width from a fresh init (1 microbatch, no compression, warmup "
          f"1): the last loss below the first: {json.dumps(memo)}",
          flush=True)
    del first
    _free(device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        versus = _train_card_vs_cpu(device)
        print(f"[16/17] (c) card == CPU, f32, TF32 off: one train step of "
              f"each smoke family (attention at the true fan-in; loss, grad "
              f"norm, gradient within {STEP_TOL} of scale, params within "
              f"{STEP_TOL} where |g| > {RESOLVED}), rmsnorm and flash "
              f"Functions within {LAYER_TOL}; bf16 flash backward at "
              f"{FLASH_FULL} against f32 autograd within {FLASH_BF16_TOL}: "
              f"{json.dumps(versus)} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        restart = _train_restart(device, kernels)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    secs = time.perf_counter() - t_phase
    print(f"[16/17] (d) Supervisor over {RESTART_ARCH} smoke, "
          f"{RESTART_STEPS} steps, a checkpoint every {RESTART_EVERY}, a "
          f"failure at step {RESTART_FAIL}: one restart, the final loss == "
          f"the straight run's within {STEP_TOL}, B1 a shard filter, the "
          f"layer-range restore exact: {json.dumps(restart)} "
          f"({time.perf_counter() - t0:.1f} s); phase 16 in {secs:.1f} s "
          f"on {smi}", flush=True)
    return {"launches": {"data_insert": full["launches"].get("insert", 0),
                         "dedup_point": full["launches"].get("point", 0),
                         "window_range": full["launches"].get("range", 0),
                         "checkpoint_insert": restart[
                             "b1_checkpoint_launches"],
                         "layer_range": restart["layer_range"][
                             "b3_launches"]},
            "full": full, "phase_s": secs}


# ---------------------------------------------------------------------------
# phase 17: sharding, the cost count and the dry run
# ---------------------------------------------------------------------------

EP_ARCH = "moonshot-v1-16b-a3b"
EP_B, EP_T = 2, 64            # prefill of EP_T tokens, one decode step
EP_TOL = 2e-2                 # of the logits' scale, bf16 activations
COST_BAND = (0.9, 1.1)        # cost.py's FLOPs / phase 16's shape count
DRY_ARCHS = "qwen3-1.7b,mamba2-130m,moonshot-v1-16b-a3b"
DRY_SHAPES = "train_4k,decode_32k"
DRY_TIMEOUT = 900


def _dry_runs(out_dir):
    """(c) the dry run's two invocations in one CPU-only subprocess (a
    fake process group cannot share this process's NCCL one), started
    with the phase; returns the Popen."""
    code = (
        "import json, subprocess, sys, time\n"
        "out = sys.argv[1]\n"
        "runs = {}\n"
        "for tag, args in (('smoke', ['--smoke', '--arch', "
        f"'{DRY_ARCHS}', '--shape', '{DRY_SHAPES}', '--mesh', 'both']), "
        "('full', ['--arch', 'qwen3-1.7b', '--shape', 'train_4k', "
        "'--mesh', 'single'])):\n"
        "    t0 = time.perf_counter()\n"
        "    r = subprocess.run([sys.executable, '-m', "
        "'repro_torch.launch.dryrun', *args, '--out', "
        "f'{out}/{tag}.json'], capture_output=True, text=True)\n"
        "    runs[tag] = {'rc': r.returncode, 's': time.perf_counter() - t0,"
        " 'tail': (r.stdout + r.stderr)[-3000:]}\n"
        "json.dump(runs, open(f'{out}/runs.json', 'w'))\n")
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    return subprocess.Popen([sys.executable, "-c", code, str(out_dir)],
                            env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _ep_world(device, smi, tmp):
    """(a) the expert-parallel dispatch on an NCCL world of one."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import batch_axes_for, make_shardings
    from repro_torch.dist.sharding import place
    from repro_torch.models import moe
    from repro_torch.models.act import activation_mesh
    from repro_torch.models.config import Shape
    from repro_torch.models.params import tree_map
    from repro_torch.serve import grow_cache

    from torch.distributed.device_mesh import init_device_mesh

    t_part = time.perf_counter()
    full = get_config(EP_ARCH)
    cfg, model, params, made = _serve_model(
        device, full.name, None,
        dataclasses.replace(full, n_layers=MOONSHOT_LAYERS))
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(SEED + 170)
    toks = torch.tensor(rng.integers(0, cfg.vocab - 1, (EP_B, EP_T + 1)),
                        dtype=torch.int32, device=device)
    pre = {"tokens": toks[:, :EP_T]}
    dec = {"token": toks[:, EP_T:], "pos": EP_T}
    local_ms, mesh_ms = {}, {}

    def timed(log, key, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        log.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return out

    for _ in range(3):
        logits, cache = timed(local_ms, "prefill",
                              lambda: model.prefill(params, pre))
        grown = grow_cache(model, cache, EP_T + 1, EP_B)
        dlog, _ = timed(local_ms, "decode",
                        lambda: model.decode(params, grown, dec))
    del cache, grown
    sh = make_shardings(model, mesh, Shape("p", EP_T, EP_B, "prefill"))
    sh_dec = make_shardings(model, mesh, Shape("d", EP_T + 1, EP_B,
                                               "decode"))
    placed = place(params, sh.params)
    ep_calls = []
    ep = moe._expert_apply_split

    def counted(*a, **kw):
        ep_calls.append(1)
        return ep(*a, **kw)

    moe._expert_apply_split = counted
    try:
        with activation_mesh(mesh, batch_axes_for(mesh)):
            for _ in range(3):
                m_logits, m_cache = timed(
                    mesh_ms, "prefill",
                    lambda: model.prefill(placed, place(pre, sh.batch)))
                m_cache = place(grow_cache(model, tree_map(
                    lambda t: t.full_tensor(), m_cache), EP_T + 1, EP_B),
                    sh_dec.cache)
                m_dlog, _ = timed(mesh_ms, "decode", lambda: model.decode(
                    placed, m_cache, place(dec, sh_dec.batch)))
    finally:
        moe._expert_apply_split = ep
    m_logits, m_dlog = m_logits.full_tensor(), m_dlog.full_tensor()
    out = {}
    for name, a, b in (("prefill", logits, m_logits),
                       ("decode", dlog, m_dlog)):
        scale = float(a.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        same = bool(torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1)))
        if not (torch.isfinite(b).all() and err <= EP_TOL * scale and same):
            raise AssertionError(f"EP {name} != local: {err} of {scale}, "
                                 f"greedy equal {same}")
        out[name] = {"max_abs_err": err, "logit_scale": scale,
                     "greedy_equal": same}
    if len(ep_calls) != 3 * 2 * cfg.n_layers:
        raise AssertionError(f"expert-parallel dispatch taken "
                             f"{len(ep_calls)} times, expected "
                             f"{6 * cfg.n_layers}")
    out.update({
        "ep_dispatch_calls": len(ep_calls), "mesh": {"data": 1, "model": 1},
        "activations": cfg.dtype, "batch": [EP_B, EP_T],
        "local_ms": {k: float(np.median(v[1:])) for k, v in
                     local_ms.items()},
        "mesh_ms": {k: float(np.median(v[1:])) for k, v in mesh_ms.items()},
        "params": made["params"], "max_memory_allocated": _peak(device),
        "part_s": time.perf_counter() - t_part})
    print(f"[17/17] (a) {EP_ARCH} at full width ({cfg.n_experts} experts, "
          f"top-{cfg.experts_per_token}, d_model {cfg.d_model}) cut to "
          f"{cfg.n_layers} of {full.n_layers} layers, params placed by "
          f"make_shardings on a 1 x 1 DeviceMesh of an NCCL world of one "
          f"under activation_mesh: every MoE layer took the expert-parallel "
          f"dispatch, prefill logits and a decode step == the local "
          f"dispatch within {EP_TOL} of scale, greedy tokens equal: "
          f"{json.dumps(out)} on {smi}", flush=True)
    del model, params, placed, m_cache
    _free(device)
    return mesh, out


def _cost_and_restore(device, smi, mesh, train, tmp):
    """(b) cost.py on phase 16's step on meta tensors; elastic_restore of
    a checkpoint onto the 1 x 1 mesh."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import ef_init
    from repro_torch.dist.sharding import make_shardings
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import measure, roofline
    from repro_torch.models import get_model
    from repro_torch.models.config import Shape
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import (OptConfig, TrainConfig, make_train_step,
                                   save_checkpoint)
    from repro_torch.train.fault_tolerance import elastic_restore

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    model = get_model(cfg, "meta")
    params = dryrun.param_sds(model)
    opt = dryrun.opt_sds(params)
    step = make_train_step(model, OptConfig(**TRAIN_OPT),
                           TrainConfig(microbatches=TRAIN_MB,
                                       grad_compression=True))
    batch = {k: torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    _, cost = measure(step, params, opt, ef_init(params), batch)
    shape_tflop = train["matmul_tflop_per_step"]
    ratio = cost.flops / 1e12 / shape_tflop
    terms = roofline(cost, dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW)
    if not COST_BAND[0] <= ratio <= COST_BAND[1]:
        raise AssertionError(f"cost.py {cost.flops / 1e12} TFLOP vs the "
                             f"shape count {shape_tflop}: {ratio}")
    busy = train.get("step_profile") or {}
    # the shape count recomputes each layer's whole forward; torch's
    # checkpoint stops recomputing once every saved tensor is back, so the
    # block's last product (w_down: its output feeds only the residual
    # add) is not run again
    skipped = 2 * TRAIN_B * TRAIN_S * cfg.d_model * cfg.d_ff * \
        cfg.n_layers / 1e12
    out = {"cost_tflop": cost.flops / 1e12, "shape_tflop": shape_tflop,
           "ratio": ratio, "remat_skipped_tflop": skipped,
           "ratio_without_skipped": cost.flops / 1e12 /
           (shape_tflop - skipped), "bytes": cost.bytes,
           "roofline_terms_ms": {k: 1e3 * v for k, v in terms.items()},
           "phase16_step_ms_median": train["step_ms_median"],
           "phase16_device_ms": busy.get("device_ms"),
           "count_s": time.perf_counter() - t0}
    # a checkpoint as phase 16's restart writes one, restored onto the mesh
    t1 = time.perf_counter()
    small = get_config(RESTART_ARCH, smoke=True)
    smodel = get_model(small, device)
    sparams = smodel.init(torch.Generator(device).manual_seed(SEED))
    save_checkpoint(f"{tmp}/ckpt", 1, sparams, device="cpu")   # no B1
    sh = make_shardings(smodel, mesh, Shape("t", 32, 4, "train"))
    back = elastic_restore(f"{tmp}/ckpt", 1, sparams, shardings=sh.params)
    leaves = list(zip(tree_leaves(back), tree_leaves(sparams),
                      tree_leaves(sh.params)))
    if not all(tuple(a.placements) == s.placements and
               torch.equal(a.full_tensor(), b) for a, b, s in leaves):
        raise AssertionError("elastic_restore onto the mesh != the saved "
                             "leaves")
    out["elastic_restore"] = {"arch": small.name, "leaves": len(leaves),
                              "bit_equal": True,
                              "s": time.perf_counter() - t1}
    print(f"[17/17] (b) launch/cost.py on phase 16's step ({TRAIN_ARCH} at "
          f"full width, {TRAIN_B} x {TRAIN_S}, {TRAIN_MB} microbatches, "
          f"error feedback; meta tensors, one device, no mesh): FLOPs within "
          f"{COST_BAND} of phase 16's shape count, roofline terms (H100 "
          f"peaks: {dryrun.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
          f"{dryrun.HBM_BW / 1e12} TB/s) beside phase 16's measured step; "
          f"elastic_restore(..., shardings=) of a {RESTART_ARCH} smoke "
          f"checkpoint onto the 1 x 1 mesh == the saved leaves bit for "
          f"bit: {json.dumps(out)} on {smi}", flush=True)
    return out


def _dry_check(proc, out_dir, smi):
    """(c) the dry run's records: every smoke cell ok; the full-width
    cell's argument bytes == its spec tree's local shards."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_specs
    from repro_torch.models import SHAPES, get_model
    from repro_torch.models.params import P, tree_leaves

    proc.wait(timeout=DRY_TIMEOUT)
    runs = json.loads((out_dir / "runs.json").read_text())
    for tag, r in runs.items():
        if r["rc"] != 0:
            raise AssertionError(f"dry run {tag}: rc {r['rc']}: {r['tail']}")
    smoke = json.loads((out_dir / "smoke.json").read_text())
    (full,) = json.loads((out_dir / "full.json").read_text())
    if len(smoke) != 12 or any(r["status"] != "ok" for r in smoke + [full]):
        raise AssertionError(f"dry run records: {smoke + [full]}")
    sizes = {"data": 16, "model": 16}
    model = get_model(get_config("qwen3-1.7b"), "meta")
    shape = SHAPES["train_4k"]
    specs = make_specs(model, sizes, shape)

    def local(spec, dims, dtype):
        n = 1
        for d, e in zip(dims, tuple(spec) + (None,) * len(dims)):
            axes = () if e is None else ((e,) if isinstance(e, str) else e)
            n *= d // math.prod(sizes[a] for a in axes)
        return n * torch.empty((), dtype=dtype).element_size()

    table = tree_leaves(model.table(), is_leaf=lambda x: isinstance(x, P))
    params = sum(local(s, p.shape, torch.float32)
                 for s, p in zip(tree_leaves(specs.params), table))
    ins = model.input_specs(shape)
    want = 3 * params + 4 + sum(local(specs.batch[k], ins[k].shape,
                                      ins[k].dtype) for k in ins)
    got = full["memory_analysis"]["argument_bytes"]
    if got != want:
        raise AssertionError(f"full-width argument_bytes {got} != {want}")
    keep = ("arch", "shape", "mesh", "trace_s", "flops_per_device",
            "bytes_per_device", "collective_bytes_per_device", "dominant")
    out = {"smoke_s": runs["smoke"]["s"], "full_s": runs["full"]["s"],
           "smoke": [{k: r[k] for k in keep} for r in smoke],
           "full": {**{k: full[k] for k in keep},
                    "collective_breakdown": full["collective_breakdown"],
                    "roofline_terms_s": full["roofline_terms_s"],
                    "argument_bytes": got}}
    print(f"[17/17] (c) python -m repro_torch.launch.dryrun --smoke --arch "
          f"{DRY_ARCHS} --shape {DRY_SHAPES} --mesh both: 12 records ok; "
          f"full-width qwen3-1.7b x train_4k x single: argument_bytes == "
          f"its spec tree's local shards ({want}); CPU only, meta tensors, "
          f"fake process groups: {json.dumps(out)}", flush=True)
    return out


def phase_sharding(device, smi, train):
    """Phase 17: (a) the EP dispatch on an NCCL world of one, (b) the cost
    count against phase 16 and a restore onto the mesh, (c) the dry run
    (its subprocess runs beside (a) and (b))."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = Path(tmp) / "dry"
        out_dir.mkdir()
        proc = _dry_runs(out_dir)
        try:
            dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                    rank=0, world_size=1)
            try:
                mesh, ep = _ep_world(device, smi, tmp)
                cost = _cost_and_restore(device, smi, mesh, train, tmp)
            finally:
                dist.destroy_process_group()
            dry = _dry_check(proc, out_dir, smi)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t_phase
    print(f"[17/17] phase 17 in {secs:.1f} s on {smi}", flush=True)
    return {"ep": ep, "cost": cost, "dry": dry, "phase_s": secs}


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
    print(f"[1/17] card: {smi} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"[1/17] nvcc build of src/repro_torch/csrc: {build_all():.1f} s",
          flush=True)
    print(f"[1/17] registers and spills (nvcc -Xptxas -v): "
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
    print(f"[2/17] kernel == plain on {n_lay} layouts (d 8..32, Δ 1..7, "
          f"top==d, W=64+replicas, multi-segment, exact, full size; B7/B8 "
          f"also on odd batches and replicas 3 and 5, against plain "
          f"versions bucketed at blocks of 256, "
          f"2048, 16384 lanes): max_abs_err {errs} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    main_run = phase_main_path(2_000_000, "auto", name,
                               expect(insert=8, point=4, range=4), kernels)
    if main_run["layout"]["deltas"] != big.deltas:
        raise AssertionError(f"main-path layout {main_run['layout']}")
    print(f"[3/17] main path {json.dumps(main_run)}", flush=True)
    large = phase_main_path(10_000_000, "resident", name,
                            expect(insert=39, point=4, range=4), kernels,
                            time_range=True)
    print(f"[4/17] resident 10M {json.dumps(large)}", flush=True)

    single = {k: kernels[k] for k in ("insert", "point", "range")}
    times = phase_times(device, big, single)
    print(f"[5/17] times at {CHUNK} keys/queries, filter "
          f"{big.total_u32 * 4} B, on {smi}: {json.dumps(times)}", flush=True)

    t0 = time.perf_counter()
    stacked = phase_stacked_vs_plain(device, kernels, errs, big)
    stacked_times = stacked.pop("times")
    times.update(stacked_times)
    print(f"[6/17] B4 == plain on {stacked['scan_cells_checked']} (scan, run) "
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
    print(f"[7/17] store, {STORE_KEYS} keys loaded by put (the key count is "
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
    print(f"[8/17] HBM-scale filter, {HBM_KEYS} keys under auto, grown x{GROW} "
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
    print(f"[8/17] B1 alone on its traffic shapes ((a) the phase-3 filter in "
          f"the L2, (b) phase 8's states cold, each of {COLD_CHUNKS} chunks "
          f"captured once, (c) phase 7's flush and largest rebuild, sorted "
          f"keys) on {smi}: {json.dumps(b1_shapes)}", flush=True)

    call_ms = {k: t.pop("call_ms") for k, t in times.items()}
    print(f"[8/17] kernel wrappers' ms per call by CUDA events over 200 "
          f"back-to-back calls, host dispatch included (the kernels line's "
          f"ms is the kernel alone, from a CUDA graph): "
          f"{json.dumps(call_ms)}", flush=True)
    t0 = time.perf_counter()
    wide = phase_wide(device, kernels)
    beside = {"phase3_u32": {k: main_run[k] for k in (
        "insert_keys_per_s", "point_queries_per_s", "range_queries_per_s")},
              "phase7_store": {k: store[k] for k in (
                  "load_puts_per_s", "host_scans_per_s")}}
    print(f"[9/17] 64-bit keys on the plain path on the card, no kernel "
          f"launched: mix64 == numpy on {MIX64_KEYS} keys with the top bit "
          f"set; the default open_filter (u64) and an f64 filter of "
          f"{WIDE_KEYS} keys with no false negatives, {SUBSAMPLE} verdicts "
          f"== the CPU's; a d = 64 store of {WIDE_STORE_KEYS} keys (phase "
          f"7's load), "
          f"YCSB-E scans == numpy oracle: {json.dumps(wide)}; beside "
          f"{json.dumps(beside)}, on {smi} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    durable, obs_run = _durable_and_obs(device, kernels, expect, smi)
    tuned = phase_tuned(device, kernels, errs, smi)
    twin = tuned["twin"]
    for shape, row in twin.pop("b1_shapes").items():
        row.pop("max_abs_err")
        b1_shapes[shape] = row
    banks = phase_banks(device, kernels, errs, smi)
    bank, tenant, prefix = banks["bank"], banks["tenant"], banks["prefix"]
    for label, row in (("e_bank_row", bank.pop("b1_row")),
                       ("e_tenant_row", tenant.pop("b1_row")),
                       ("e_tenant_meta_row", tenant.pop("b1_meta_row"))):
        errs["insert"] = max(errs["insert"], row.pop("max_abs_err"))
        b1_shapes[label] = row
    if errs["insert"] or errs["point_stacked"]:
        raise AssertionError(f"B1 or B6 != plain on a bank shape: {errs}")
    serve = phase_serve(device, kernels, smi)
    families = phase_families(device, kernels, smi)
    trained = phase_train(device, kernels, smi)
    train = trained["launches"]
    phase_sharding(device, smi, trained["full"])
    times["point_stacked"]["bank_shapes"] = {
        "phase13_bank": bank.pop("b6"), "phase13_tenant": tenant.pop("b6")}
    for row in times["point_stacked"]["bank_shapes"].values():
        row.pop("max_abs_err")
    times["point_stacked"]["launches_by_path"] = {
        "phase6_stacked_path": stacked["launches"]["point_stacked"],
        "phase13_bank_points": bank["launches"]["points"],
        "phase13_tenant_points": tenant["launches"]["points"],
        "phase13_tenant_grown_points": tenant["launches"]["grown_points"],
        "phase13_prefix_lookups": prefix["launches"]["point_stacked"],
        "phase14_serve_lookups": serve["launches"]["point_stacked"],
        "phase15_serve_lookups": families["launches"]["point_stacked"]}
    times["insert"]["launches_by_path"] = {
        "phase3_main": main_run["launches"]["insert"],
        "phase7_store_builds": store["b1_launches"],
        "phase8_hbm": hbm["launches"]["insert"],
        "phase10_durable_builds": durable["b1_launches"],
        "phase11_obs_on": obs_run["launches_on"]["insert"],
        "phase12_adaptive_builds": twin["adaptive"]["b1_launches"],
        "phase12_static_builds": twin["auto"]["b1_launches"],
        "phase12_adapter": tuned["standalone"]["bloomrf"]["launches"][
            "insert"],
        "phase13_bank_rows": bank["launches"]["build"],
        "phase13_tenant_rows": tenant["launches"]["build"],
        "phase13_ttl_tenant_rows": tenant["launches"]["ttl_build"],
        "phase13_prefix_cache": prefix["launches"]["insert"],
        "phase14_serve_freezes": serve["launches"]["insert"],
        "phase15_serve_freezes": families["launches"]["insert"],
        "phase16_train_data": train["data_insert"],
        "phase16_train_checkpoints": train["checkpoint_insert"]}
    times["point"]["launches_by_path"] = {
        "phase3_main": main_run["launches"]["point"],
        "phase16_train_dedup": train["dedup_point"]}
    times["range"]["launches_by_path"] = {
        "phase3_main": main_run["launches"]["range"],
        "phase16_train_window": train["window_range"],
        "phase16_layer_range_restore": train["layer_range"]}
    times["store_scan"]["launches_by_path"] = {
        "phase7_store": store["launches"],
        "phase10_durable": durable["launches"],
        "phase12_adaptive": twin["adaptive"]["b4_launches"],
        "phase12_static": twin["auto"]["b4_launches"],
        "phase13_prefix_sweeps": prefix["launches"]["store_scan"]}
    times["store_scan"]["phase12_batch_ms"] = {
        t: {k: twin[t][k] for k in ("b4_ms", "b4_plain_ms", "runs")}
        for t in ("adaptive", "auto")}
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
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
