"""The CUDA kernels on a card, held to their plain PyTorch versions on the
same card, bit for bit.  Marked ``gpu``: they skip where no CUDA device is
present, and run with ``python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports neither ``jax`` nor ``repro``, so it runs on a machine
that has only PyTorch."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import BloomRF, FilterLayout, basic_layout, stacked_probe
from repro_torch.kernels import (FilterOps, build_run_stack, insert_resident,
                                 point_probe_partitioned,
                                 point_probe_resident,
                                 point_probe_stacked_resident,
                                 range_probe_partitioned,
                                 range_probe_resident,
                                 range_probe_stacked_resident,
                                 store_scan_probe, store_scan_probe_flat)
from repro_torch.kernels.probe import point_partitioned_plain
from repro_torch.kernels.rangeprobe import range_partitioned_plain
from repro_torch.store import Store, StoreConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card; decided here, never at import, so every pytest-xdist
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


_LAYOUTS = {
    **{f"d{d}_delta{dl}": (lambda d=d, dl=dl: basic_layout(d, 3000, 16.0,
                                                           delta=dl))
       for d in (8, 16, 24, 32) for dl in (1, 4, 7)},
    "top_eq_d": lambda: basic_layout(32, 2, 16.0),
    "w64_replicas": lambda: FilterLayout(
        d=32, deltas=(7, 7), replicas=(1, 2), seg_of_layer=(0, 0),
        seg_bits=(16384,)),
    "multiseg": lambda: FilterLayout(
        d=32, deltas=(6, 5, 4), replicas=(2, 1, 2), seg_of_layer=(0, 1, 0),
        seg_bits=(8192, 4096)),
}

_EXACT = FilterLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                      seg_of_layer=(2, 2, 1, 1),
                      seg_bits=(1 << 12, 4096, 8192), exact_seg=0)


def _inputs(lay, device, n=3000, q=20_000, seed=0):
    rng = np.random.default_rng(seed)
    top = (1 << lay.d) - 1
    keys = rng.integers(0, top + 1, n, dtype=np.uint64)
    lo = rng.integers(0, top + 1, q, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << min(lay.d - 1, 14), q,
                                      dtype=np.uint64), top)
    lo[:4] = [0, 0, top, 9]
    hi[:4] = [top, 0, top, 2]          # full domain, lo = hi, lo > hi
    as_t = [torch.from_numpy(a.astype(np.int64)).to(device)
            for a in (keys, lo, hi)]
    return as_t


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_kernels_match_plain_versions(cuda, name):
    lay = _LAYOUTS[name]()
    f = BloomRF(lay, device=cuda)
    keys, lo, hi = _inputs(lay, cuda)
    plain = f.insert(f.init_state(), keys)
    n0 = insert_resident.launches
    state = insert_resident(lay, f.init_state(), keys)
    assert insert_resident.launches == n0 + 1
    torch.testing.assert_close(state, plain, rtol=0, atol=0)
    qs = torch.cat([keys[:1000], lo])
    torch.testing.assert_close(point_probe_resident(lay, state, qs),
                               f.engine.point_batched(state, qs))
    torch.testing.assert_close(range_probe_resident(lay, state, lo, hi),
                               f.engine.range_batched(state, lo, hi))
    torch.testing.assert_close(range_probe_resident(lay, state, hi, lo),
                               f.engine.range_batched(state, lo, hi))
    torch.cuda.synchronize()


def test_exact_layout_insert_and_point_kernels(cuda):
    f = BloomRF(_EXACT, device=cuda)
    keys, lo, _ = _inputs(_EXACT, cuda)
    state = insert_resident(_EXACT, f.init_state(), keys)
    torch.testing.assert_close(state, f.insert(f.init_state(), keys),
                               rtol=0, atol=0)
    qs = torch.cat([keys, lo])
    torch.testing.assert_close(point_probe_resident(_EXACT, state, qs),
                               f.engine.point_batched(state, qs))
    with pytest.raises(ValueError, match="exact"):
        range_probe_resident(_EXACT, state, lo, lo)


def test_facade_auto_routes_through_kernels(cuda):
    h = repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32", n=50_000))
    twin = repro_torch.open_filter(
        repro_torch.FilterSpec(dtype="u32", n=50_000, backend="xla"))
    assert h.backend == "kernels" and h.state.is_cuda
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 32, 50_000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64)
    hi = np.minimum(lo + np.uint64(1 << 10), np.uint64((1 << 32) - 1))
    counts = (insert_resident.launches, point_probe_resident.launches,
              range_probe_resident.launches)
    h.insert(keys)
    twin.insert(keys)
    np.testing.assert_array_equal(h.state_numpy(), twin.state_numpy())
    np.testing.assert_array_equal(h.range(lo, hi), twin.range(lo, hi))
    assert h.point(keys).all()
    assert (insert_resident.launches - counts[0],
            point_probe_resident.launches - counts[1],
            range_probe_resident.launches - counts[2]) == (1, 1, 1)


# ---------------------------------------------------------------------------
# the partitioned kernels (B7/B8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block_u32", [256, 2048, 16384])
@pytest.mark.parametrize("name", ["d16_delta4", "d32_delta1", "d32_delta7",
                                  "top_eq_d", "w64_replicas", "multiseg"])
def test_partitioned_kernels_match_plain_versions(cuda, name, block_u32):
    lay = _LAYOUTS[name]()
    f = BloomRF(lay, device=cuda)
    keys, lo, hi = _inputs(lay, cuda)
    state = insert_resident(lay, f.init_state(), keys)
    qs = torch.cat([keys[:1000], lo])
    n0 = (point_probe_partitioned.launches, range_probe_partitioned.launches)
    pts = point_probe_partitioned(lay, state, qs, 512, block_u32)
    rgs = range_probe_partitioned(lay, state, lo, hi, 512, block_u32)
    assert (point_probe_partitioned.launches - n0[0],
            range_probe_partitioned.launches - n0[1]) == (1, 1)
    torch.testing.assert_close(
        pts, point_partitioned_plain(lay, state, qs, 512, block_u32))
    torch.testing.assert_close(pts, f.engine.point_batched(state, qs))
    torch.testing.assert_close(
        rgs, range_partitioned_plain(lay, state, lo, hi, 512, block_u32))
    torch.testing.assert_close(rgs, f.engine.range_batched(state, lo, hi))
    torch.testing.assert_close(
        range_probe_partitioned(lay, state, hi, lo, 512, block_u32), rgs)
    if name == "d32_delta7":          # the exact layout's points, too
        xf = BloomRF(_EXACT, device=cuda)
        xs = insert_resident(_EXACT, xf.init_state(), keys)
        torch.testing.assert_close(
            point_probe_partitioned(_EXACT, xs, qs, 512, block_u32),
            xf.engine.point_batched(xs, qs))


_PART_EDGE_LAYOUTS = {
    "w64_replicas3": lambda: FilterLayout(
        d=32, deltas=(7, 7), replicas=(3, 1), seg_of_layer=(0, 0),
        seg_bits=(16384,)),
    "w8_replicas5": lambda: FilterLayout(
        d=32, deltas=(4, 4, 4), replicas=(5, 1, 3), seg_of_layer=(0, 0, 0),
        seg_bits=(16384,)),
    "top_eq_d": _LAYOUTS["top_eq_d"],
    "d32_delta1": _LAYOUTS["d32_delta1"],
}


@pytest.mark.parametrize("name", list(_PART_EDGE_LAYOUTS))
def test_partitioned_kernels_edge_bounds_and_batches(cuda, name):
    """B7/B8 at the edges: swapped bounds, lo == hi, the whole domain, a
    batch that is not a multiple of the thread block, an empty batch; over
    W = 64 and W = 8 words with more replicas than a range word issues at
    once, top level = d = 32 and 21 layers (d = 32, Δ = 1)."""
    lay = _PART_EDGE_LAYOUTS[name]()
    f = BloomRF(lay, device=cuda)
    keys, lo, hi = _inputs(lay, cuda, q=1001)
    state = insert_resident(lay, f.init_state(), keys)
    top = (1 << 32) - 1
    edges = torch.tensor([[0, top], [top, 0], [0, 0], [top, top], [9, 2],
                          [5, 5], [1 << 31, (1 << 31) - 1]],
                         dtype=torch.int64, device=cuda)
    lo = torch.cat([edges[:, 0], keys[:40], lo])
    hi = torch.cat([edges[:, 1], keys[:40], hi])
    assert lo.numel() % 256
    qs = torch.cat([keys[:500], lo])
    n0 = (point_probe_partitioned.launches, range_probe_partitioned.launches)
    pts = point_probe_partitioned(lay, state, qs)
    rgs = range_probe_partitioned(lay, state, lo, hi)
    assert (point_probe_partitioned.launches - n0[0],
            range_probe_partitioned.launches - n0[1]) == (1, 1)
    torch.testing.assert_close(pts, point_partitioned_plain(lay, state, qs))
    torch.testing.assert_close(pts, f.engine.point_batched(state, qs))
    assert pts[:500].all()
    want = range_partitioned_plain(lay, state, lo, hi)
    torch.testing.assert_close(rgs, want)
    torch.testing.assert_close(rgs, f.engine.range_batched(state, lo, hi))
    torch.testing.assert_close(range_probe_partitioned(lay, state, hi, lo),
                               want)
    assert rgs[:2].all() and rgs[7:47].all()       # whole domain, keys
    empty = lo[:0]
    assert point_probe_partitioned(lay, state, empty).shape == (0,)
    assert range_probe_partitioned(lay, state, empty, empty).shape == (0,)
    assert (point_probe_partitioned.launches - n0[0],
            range_probe_partitioned.launches - n0[1]) == (1, 2)
    with pytest.raises(ValueError, match="tile"):
        range_probe_partitioned(lay, state, lo, hi, 0, 256)
    torch.cuda.synchronize()


def test_facade_auto_above_the_budget_takes_the_partitioned_kernels(cuda):
    """Under ``auto`` a filter above the resident budget launches B7/B8 and
    never B2/B3; after ``grow`` it stays there and agrees with the ``xla``
    twin."""
    kw = dict(dtype="u32", n=600_000)
    twin = repro_torch.open_filter(repro_torch.FilterSpec(backend="xla",
                                                          **kw))
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1 << 32, 600_000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64)
    hi = np.minimum(lo + np.uint64(1 << 10), np.uint64((1 << 32) - 1))
    fns = (point_probe_resident, range_probe_resident,
           point_probe_partitioned, range_probe_partitioned)
    before = [fn.launches for fn in fns]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BLOOMRF_VMEM_BUDGET_U32", str(1 << 16))
        h = repro_torch.open_filter(repro_torch.FilterSpec(**kw))
        assert h.backend == "kernels" and not h.ops.resident
        for step in range(2):
            for x in (h, twin):
                x.insert(keys[step::2])
            np.testing.assert_array_equal(h.state_numpy(),
                                          twin.state_numpy())
            np.testing.assert_array_equal(h.range(lo, hi), twin.range(lo, hi))
            np.testing.assert_array_equal(h.point(lo), twin.point(lo))
            assert h.point(keys[:2 * 300_000:2]).all()
            for x in (h, twin):
                x.grow(4)
            assert not h.ops.resident
    launched = [fn.launches - b for fn, b in zip(fns, before)]
    assert launched == [0, 0, 6, 2]


def test_mutable_filters_on_the_card_match_the_xla_twin(cuda):
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 1 << 32, 200_000, dtype=np.uint64)
    for mut in ("deletable", "ttl"):
        kw = dict(dtype="u32", n=200_000, mutability=mut, generations=3)
        h = repro_torch.open_filter(repro_torch.FilterSpec(
            backend="partitioned", **kw))
        twin = repro_torch.open_filter(repro_torch.FilterSpec(
            backend="xla", **kw))
        for x in (h, twin):
            x.insert(keys[:100_000])
            if mut == "deletable":
                x.delete(keys[:50_000])
            else:
                x.advance_generation()
            x.grow(4)
            x.insert(keys[100_000:])
        np.testing.assert_array_equal(h.state_numpy(), twin.state_numpy())
        if mut == "deletable":
            np.testing.assert_array_equal(h.counts.counts, twin.counts.counts)
        assert h.point(keys[50_000:]).all()
        np.testing.assert_array_equal(h.point(keys), twin.point(keys))


# ---------------------------------------------------------------------------
# the stacked kernels (B5/B6) and the store-scan kernel (B4)
# ---------------------------------------------------------------------------

def _rows(layouts, device, rng, n=800):
    """One filled row per layout, with its key fences."""
    states, kmin, kmax = [], [], []
    for lay in layouts:
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        f = BloomRF(lay, device=device)
        states.append(f.insert(f.init_state(),
                               torch.from_numpy(keys.astype(np.int64)).to(
                                   device)))
        kmin.append(int(keys.min()))
        kmax.append(int(keys.max()))
    return states, kmin, kmax


@pytest.mark.parametrize("name", ["d32_delta4", "d32_delta7", "w64_replicas",
                                  "multiseg", "top_eq_d"])
def test_stacked_kernels_match_plain_versions(cuda, name):
    lay = _LAYOUTS[name]()
    rng = np.random.default_rng(5)
    states, _, _ = _rows([lay] * 3, cuda, rng)
    stack = torch.stack(states)
    keys, lo, hi = _inputs(lay, cuda)
    plain = stacked_probe((lay,) * 3, tuple(r * lay.total_u32
                                            for r in range(3)), cuda)
    flat = stack.reshape(-1)
    n0 = (range_probe_stacked_resident.launches,
          point_probe_stacked_resident.launches)
    torch.testing.assert_close(range_probe_stacked_resident(lay, stack, lo, hi),
                               plain.range_all(flat, lo, hi))
    torch.testing.assert_close(range_probe_stacked_resident(lay, stack, hi, lo),
                               plain.range_all(flat, lo, hi))
    qs = torch.cat([keys[:1000], lo])
    torch.testing.assert_close(point_probe_stacked_resident(lay, stack, qs),
                               plain.point_all(flat, qs))
    assert (range_probe_stacked_resident.launches - n0[0],
            point_probe_stacked_resident.launches - n0[1]) == (2, 1)
    ops = FilterOps(lay)                   # the dispatcher takes the kernels
    torch.testing.assert_close(ops.range_stacked(stack, lo, hi),
                               plain.range_all(flat, lo, hi))
    torch.cuda.synchronize()


def test_store_scan_kernel_matches_plain_version(cuda):
    rng = np.random.default_rng(6)
    c0 = basic_layout(32, 400, 14.0, delta=6)
    layouts = (c0, c0, _LAYOUTS["w64_replicas"](), _LAYOUTS["multiseg"](),
               basic_layout(32, 6400, 14.0, delta=6))
    states, kmin, kmax = _rows(layouts, cuda, rng)
    _, lo, hi = _inputs(layouts[0], cuda)
    lo[4:8] = torch.tensor(kmin[:4], device=cuda)
    hi[4:8] = lo[4:8]                                 # lo = hi on a fence
    lo[8:10] = torch.tensor(kmax[:2], device=cuda) + 1  # just off a fence
    R = len(layouts)
    sizes = [lay.total_u32 for lay in layouts]
    bases = tuple(int(b) for b in np.cumsum([0] + sizes[:-1]))
    flat = torch.cat(states)
    tk = [torch.tensor(v, dtype=torch.int64, device=cuda) for v in (kmin, kmax)]
    plain = stacked_probe(layouts, bases, cuda)
    stack = build_run_stack(states)
    for quar in (None, torch.arange(R, device=cuda) == 2):
        want = plain.touch_all(flat, *tk, lo, hi, quar)
        n0 = store_scan_probe.launches
        got = [store_scan_probe_flat(layouts, bases, flat, *tk, lo, hi,
                                     quarantine=quar)]
        got += [store_scan_probe(layouts, stack, *tk, lo, hi, 128, rpb, quar)
                for rpb in (0, 2)]
        assert store_scan_probe.launches == n0 + 3
        for fence, touch in got:
            torch.testing.assert_close(fence, want[0])
            torch.testing.assert_close(touch, want[1])
    torch.cuda.synchronize()


def test_store_on_the_card_scans_through_the_kernel(cuda):
    cfg = dict(memtable_limit=256, level0_runs=2, fanout=2)
    st, twin = Store(StoreConfig(**cfg)), Store(StoreConfig(
        scan_backend="xla", **cfg))
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 32, 4000, dtype=np.uint64)
    for i, k in enumerate(keys):
        st.put(int(k), i)
        twin.put(int(k), i)
    st.live_runs()                         # the mode follows the live stack
    assert st.device.type == "cuda" and st._scan_kernel_mode() == "kernel"
    twin.live_runs()
    assert twin._scan_kernel_mode() == "xla"
    lo = rng.integers(0, 1 << 32, 300, dtype=np.uint64)
    hi = lo + np.uint64(1 << 22)                  # some past the domain
    n0 = store_scan_probe.launches
    assert st.scan_many(lo, hi) == twin.scan_many(lo, hi)
    assert store_scan_probe.launches == n0 + 1
    assert st.stats.as_dict() == twin.stats.as_dict()
    assert st.stats.kernel_fallbacks == 0 and len(st.live_runs()) > 1


# ---------------------------------------------------------------------------
# the redesigned range read plan (B3) and store-scan kernel (B4)
# ---------------------------------------------------------------------------

_B3_LAYOUTS = {
    **{f"delta{dl}": (lambda dl=dl: basic_layout(32, 3000, 16.0, delta=dl))
       for dl in range(1, 8)},
    "w64_replicas3": _PART_EDGE_LAYOUTS["w64_replicas3"],
    "w8_replicas5": _PART_EDGE_LAYOUTS["w8_replicas5"],
    "top_eq_d": _LAYOUTS["top_eq_d"],
}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(_B3_LAYOUTS))
def test_range_kernel_read_plan_matches_plain_version(cuda, name, aligned):
    """B3 over Δ 1..7, replicas 3 and 5 and top = d = 32, on a state that is
    8-byte aligned and on a view of it that is only 4-byte aligned (a W = 64
    word then takes two 4-byte loads)."""
    lay = _B3_LAYOUTS[name]()
    f = BloomRF(lay, device=cuda)
    keys, lo, hi = _inputs(lay, cuda, q=20_001)
    buf = torch.zeros(lay.total_u32 + 1, dtype=torch.int32, device=cuda)
    state = buf[:-1] if aligned else buf[1:]
    assert (state.data_ptr() % 8 == 0) == aligned
    state.copy_(insert_resident(lay, f.init_state(), keys))
    lo = torch.cat([keys[:40], lo])
    hi = torch.cat([keys[:40], hi])
    want = f.engine.range_batched(state, lo, hi)
    n0 = range_probe_resident.launches
    got = range_probe_resident(lay, state, lo, hi)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(range_probe_resident(lay, state, hi, lo), want)
    assert range_probe_resident.launches == n0 + 2
    assert got[:40].all()


def test_range_kernel_on_the_main_path_layout(cuda):
    """B3 on the single filter's main-path layout (2,000,000 keys at 16
    bits/key: Δ 7, k 2, W 64) at 262,144 ranges."""
    lay = basic_layout(32, 2_000_000, 16.0, delta=7)
    f = BloomRF(lay, device=cuda)
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(0, 1 << 32, 2_000_000,
                                         dtype=np.uint64).astype(np.int64))
    state = insert_resident(lay, f.init_state(), keys.to(cuda))
    lo = rng.integers(0, 1 << 32, 1 << 18, dtype=np.uint64)
    width = np.floor(np.exp2(rng.uniform(0, 14, 1 << 18))).astype(np.uint64)
    hi = np.minimum(lo + width - np.uint64(1), np.uint64((1 << 32) - 1))
    tlo, thi = (torch.from_numpy(a.astype(np.int64)).to(cuda)
                for a in (lo, hi))
    n0 = range_probe_resident.launches
    got = range_probe_resident(lay, state, tlo, thi)
    assert range_probe_resident.launches == n0 + 1
    torch.testing.assert_close(got, f.engine.range_batched(state, tlo, thi))


def _scan_case(name, device, rng):
    c0 = basic_layout(32, 400, 14.0, delta=6)
    four = [c0, basic_layout(32, 1600, 14.0, delta=6),
            _LAYOUTS["w64_replicas"](), _LAYOUTS["multiseg"]()]
    layouts = [c0] if name == "one_row" else [four[i % 4] for i in range(40)]
    states, kmin, kmax = _rows(layouts, device, rng, n=300)
    if len(layouts) > 1:
        kmin[1], kmax[1] = (1 << 32) - 1, 0          # the empty fence
    return layouts, states, kmin, kmax


@pytest.mark.parametrize("name", ["one_row", "forty_rows_four_layouts"])
def test_store_scan_kernel_rows_fences_and_bounds(cuda, name):
    """B4 on one row and on 40 rows over 4 layouts, with and without a
    quarantine mask, an empty fence, a batch that is not a multiple of the
    block, scans that span a top-level gap and swapped bounds."""
    rng = np.random.default_rng(10)
    layouts, states, kmin, kmax = _scan_case(name, cuda, rng)
    R = len(layouts)
    top = (1 << 32) - 1
    B = 333
    lo = rng.integers(0, top + 1, B, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 20, B, dtype=np.uint64), top)
    lo[:6] = [0, 1 << 20, 5 << 24, 123, kmin[0], 9]
    hi[:6] = [top, 3 << 20, 9 << 24, 7, kmin[0], 2]   # gaps, swapped, fence
    assert (B * R) % 64
    tlo, thi = (torch.from_numpy(a.astype(np.int64)).to(cuda)
                for a in (lo, hi))
    sizes = [lay.total_u32 for lay in layouts]
    bases = tuple(int(b) for b in np.cumsum([0] + sizes[:-1]))
    flat = torch.cat(states)
    tk = [torch.tensor(v, dtype=torch.int64, device=cuda)
          for v in (kmin, kmax)]
    plain = stacked_probe(tuple(layouts), bases, cuda)
    for quar in (None, torch.arange(R, device=cuda) % 3 == 0):
        want = plain.touch_all(flat, *tk, tlo, thi, quar)
        n0 = store_scan_probe.launches
        fence, touch = store_scan_probe_flat(layouts, bases, flat, *tk, tlo,
                                             thi, quarantine=quar)
        assert store_scan_probe.launches == n0 + 1
        torch.testing.assert_close(fence, want[0])
        torch.testing.assert_close(touch, want[1])
        # only the whole-domain scan (row 0 of the batch) reaches the empty
        # fence (2^32 - 1, 0)
        assert R == 1 or not fence[1:, 1].any()
        if quar is not None:
            assert torch.equal(touch[:, 0], fence[:, 0])
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the insert kernel (B1) on a store build's traffic, and the store's builds
# ---------------------------------------------------------------------------

_B1_LAYOUTS = {
    "store_flush": lambda: basic_layout(32, 8192, 14.0, delta=6),
    "w64_replicas3": _PART_EDGE_LAYOUTS["w64_replicas3"],
    "w8_replicas5": _PART_EDGE_LAYOUTS["w8_replicas5"],
    "exact": lambda: _EXACT,
}


def _b1_keys(kind, rng):
    if kind == "sorted":            # a store build: neighbours share words
        return np.sort(rng.integers(0, 1 << 32, 8192, dtype=np.uint64))
    if kind == "duplicates":        # 40 distinct keys, 5000 times
        return rng.integers(0, 40, 5000, dtype=np.uint64) << np.uint64(20)
    return rng.integers(0, 1 << 32, 1001, dtype=np.uint64)  # a partial warp


@pytest.mark.parametrize("kind", ["sorted", "duplicates", "odd_batch"])
@pytest.mark.parametrize("name", list(_B1_LAYOUTS))
def test_insert_kernel_matches_plain_version(cuda, name, kind):
    """B1 bit for bit against its plain version on sorted keys, on keys with
    many duplicates and on an odd batch whose last warp is partial, over
    layouts with replicas 3 and 5 and an exact segment; into a state that
    already holds bits, too."""
    lay = _B1_LAYOUTS[name]()
    f = BloomRF(lay, device=cuda)
    rng = np.random.default_rng(11)
    keys = torch.from_numpy(_b1_keys(kind, rng).astype(np.int64)).to(cuda)
    n0 = insert_resident.launches
    state = insert_resident(lay, f.init_state(), keys)
    assert insert_resident.launches == n0 + 1
    torch.testing.assert_close(state, f.insert(f.init_state(), keys),
                               rtol=0, atol=0)
    more = torch.from_numpy(rng.integers(0, 1 << 32, 777, dtype=np.uint64)
                            .astype(np.int64)).to(cuda)
    torch.testing.assert_close(insert_resident(lay, state.clone(), more),
                               f.insert(state, more), rtol=0, atol=0)


def test_store_builds_launch_the_insert_kernel(cuda):
    """A CUDA store with the default config launches B1 once per filter build
    (every flush and every rebuild), and each run's state equals the plain
    build of its keys (distinct keys, no deletes: OR merges equal it too)."""
    st = Store(StoreConfig(memtable_limit=256, level0_runs=2, fanout=2))
    keys = np.random.default_rng(12).choice(1 << 32, 6000, replace=False)
    n0 = insert_resident.launches
    for i, k in enumerate(keys):
        st.put(int(k), i)
    st.flush()
    assert st.stats.rebuild_merges > 0
    assert insert_resident.launches - n0 == st.filter_builds \
        == st.stats.flushes + st.stats.rebuild_merges
    for run in st.live_runs():
        f = BloomRF(run.layout, device=cuda)
        want = f.build(torch.from_numpy(run.keys.astype(np.int64)).to(cuda))
        torch.testing.assert_close(run.state, want, rtol=0, atol=0)
