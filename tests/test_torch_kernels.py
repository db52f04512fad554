"""The port's kernel modules on CPU tensors (their plain path) against
``repro.kernels`` at ``interpret=True``, with the sizes of
tests/test_kernels.py, plus the dispatcher, the argument checks and the
layout descriptor the CUDA kernels read.  The CUDA launches themselves are
tested in tests/test_torch_gpu.py, on a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BloomRF as JBloomRF
from repro.core import FilterLayout as JLayout
from repro.core import basic_layout as jbasic
from repro.kernels import insert_resident as j_insert
from repro.kernels import point_probe_resident as j_point
from repro.kernels import range_probe_resident as j_range
from repro_torch.core import FilterLayout, basic_layout
from repro_torch.kernels import (FilterOps, insert_resident,
                                 point_probe_resident, range_probe_resident)
from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import layout_descriptor

_TILE = 128
_CPU = torch.device("cpu")


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def _keys(rng, d, n):
    return rng.integers(0, (1 << d) - 1, n, dtype=np.uint64)


def _port(jl):
    return FilterLayout.from_dict(dataclasses.asdict(jl))


@pytest.mark.parametrize("d,delta,n,bpk", [
    (32, 6, 2000, 12.0),
    (32, 7, 1000, 16.0),
    (24, 4, 3000, 10.0),
    (16, 2, 500, 14.0),
])
def test_insert_resident_matches_reference_kernel(rng, d, delta, n, bpk):
    jl = jbasic(d, n, bpk, delta=delta)
    lay = _port(jl)
    keys = _keys(rng, d, n)
    want = np.asarray(j_insert(jl, JBloomRF(jl, _warn=False).init_state(),
                               jnp.asarray(keys, jnp.uint32), _TILE, True))
    state = torch.zeros(lay.total_u32, dtype=torch.int32)
    before = insert_resident.launches
    out = insert_resident(lay, state, _i64(keys))
    assert out is state                       # updated in place
    assert insert_resident.launches == before  # the CPU path launches nothing
    np.testing.assert_array_equal(state.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        kref.insert_ref(lay, torch.zeros_like(state), _i64(keys)).numpy(),
        state.numpy())


@pytest.mark.parametrize("d,delta", [(32, 6), (32, 7), (20, 3)])
def test_point_probe_resident_matches_reference_kernel(rng, d, delta):
    jl = jbasic(d, 2000, 12.0, delta=delta)
    lay = _port(jl)
    keys = _keys(rng, d, 2000)
    state = kref.filter_for_layout(lay, _CPU).build(_i64(keys))
    qs = np.concatenate([keys[:500], _keys(rng, d, 1500)])
    want = np.asarray(j_point(jl, jnp.asarray(state.numpy().view(np.uint32)),
                              jnp.asarray(qs, jnp.uint32), _TILE, True))
    got = point_probe_resident(lay, state, _i64(qs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kref.point_ref(lay, state, _i64(qs)).numpy(),
                                  want)
    assert got[:500].all()  # no false negatives


@pytest.mark.parametrize("delta", [4, 7])
def test_range_probe_resident_matches_reference_kernel(rng, delta):
    jl = jbasic(32, 2000, 14.0, delta=delta)
    lay = _port(jl)
    keys = _keys(rng, 32, 2000)
    state = kref.filter_for_layout(lay, _CPU).build(_i64(keys))
    lo = _keys(rng, 32, 800)
    hi = np.minimum(lo + rng.integers(0, 1 << 10, 800).astype(np.uint64),
                    (1 << 32) - 1)
    lo[:4] = [0, 0, (1 << 32) - 1, 77]
    hi[:4] = [(1 << 32) - 1, 0, (1 << 32) - 1, 3]
    want = np.asarray(j_range(jl, jnp.asarray(state.numpy().view(np.uint32)),
                              jnp.asarray(lo, jnp.uint32),
                              jnp.asarray(hi, jnp.uint32), _TILE, True))
    got = range_probe_resident(lay, state, _i64(lo), _i64(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        kref.range_ref(lay, state, _i64(lo), _i64(hi)).numpy(), want)


def test_filter_ops_dispatch_and_exact_layouts(rng):
    lay = basic_layout(32, 1000, 12.0, delta=6)
    ops = FilterOps(lay)
    keys = _i64(_keys(rng, 32, 1000))
    state = ops.insert(kref.filter_for_layout(lay, _CPU).init_state(), keys)
    assert ops.point(state, keys[:200]).all()
    assert ops.range(state, keys[:200], keys[:200] + 3).all()
    # exact layouts: insert and point take the kernels, range the engine
    ex = FilterLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                      seg_of_layer=(2, 2, 1, 1),
                      seg_bits=(1 << 12, 4096, 8192), exact_seg=0)
    xops = FilterOps(ex)
    xs = xops.insert(kref.filter_for_layout(ex, _CPU).init_state(), keys)
    assert xops.point(xs, keys).all()
    np.testing.assert_array_equal(
        xops.range(xs, keys, keys + 5).numpy(),
        kref.range_ref(ex, xs, keys, keys + 5).numpy())
    with pytest.raises(ValueError, match="exact"):
        range_probe_resident(ex, xs, keys, keys)


def test_filter_ops_tiers_not_ported_raise():
    """Both tiers that once raised here are ported now: the partitioned
    tier (B7/B8, tests/test_torch_partitioned.py) and the stacked probes
    (B5/B6, tests/test_torch_stacked.py).  Each answers as the resident
    single filter does."""
    lay = basic_layout(32, 1000, 12.0, delta=6)
    keys = _i64(np.arange(0, 1 << 30, 1 << 20, dtype=np.uint64))
    state = kref.filter_for_layout(lay, _CPU).build(keys)
    part = FilterOps(lay, vmem_budget_u32=1)
    assert not part.resident
    assert part.point(state, keys).all()
    assert part.range(state, keys, keys + 5).all()
    ops = FilterOps(lay)
    stack = torch.stack([state, torch.zeros_like(state)])
    pts = ops.point_stacked(stack, keys)
    assert pts[:, 0].all() and not pts[:, 1].any()
    rng_v = ops.range_stacked(stack, keys, keys + 5)
    assert rng_v[:, 0].all() and not rng_v[:, 1].any()


def test_vmem_budget_env_is_validated(monkeypatch):
    from repro_torch.kernels import read_vmem_budget_u32

    monkeypatch.setenv("BLOOMRF_VMEM_BUDGET_U32", "12")
    assert read_vmem_budget_u32() == 12
    for bad in ("x", "0"):
        monkeypatch.setenv("BLOOMRF_VMEM_BUDGET_U32", bad)
        with pytest.raises(ValueError, match="BLOOMRF_VMEM_BUDGET_U32"):
            read_vmem_budget_u32()


def test_kernel_wrappers_check_arguments():
    lay = basic_layout(32, 1000, 12.0, delta=6)
    st = torch.zeros(lay.total_u32, dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        point_probe_resident(lay, st.to(torch.int64), keys)
    with pytest.raises(ValueError, match="int32"):
        insert_resident(lay, st[:-1], keys)
    with pytest.raises(ValueError, match="int64"):
        point_probe_resident(lay, st, keys.to(torch.int32))
    with pytest.raises(ValueError, match="differ"):
        range_probe_resident(lay, st, keys, keys[:5])
    with pytest.raises(ValueError, match="32-bit"):
        insert_resident(dataclasses.replace(lay, d=64), st, keys)


def test_layout_descriptor_records():
    lay = FilterLayout(d=32, deltas=(6, 5, 4), replicas=(2, 1, 2),
                       seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096))
    desc = layout_descriptor(lay).astype(np.int64)
    assert list(desc[:6]) == [32, 3, 15, 0, 0, len(desc)]
    for i in range(lay.k):
        rec = desc[8 + 8 * i: 16 + 8 * i]
        assert list(rec[:6]) == [lay.levels[i], lay.deltas[i],
                                 lay.word_bits(i), lay.nwords(i),
                                 lay.seg_off_bits[lay.seg_of_layer[i]],
                                 lay.replicas[i]]
        seeds = desc[rec[6]: rec[6] + lay.replicas[i]]
        np.testing.assert_array_equal(
            seeds, lay.seeds[i, :lay.replicas[i]].astype(np.uint64)
            & np.uint64(0xFFFFFFFF))
    ex = JLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                 seg_of_layer=(2, 2, 1, 1), seg_bits=(1 << 12, 4096, 8192),
                 exact_seg=0)
    xd = layout_descriptor(_port(ex))
    assert (xd[3], xd[4]) == (1, ex.exact_off_bits)
