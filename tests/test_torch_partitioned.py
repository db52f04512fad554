"""The port's partitioned tier on CPU tensors (the kernels' plain path)
against ``repro``'s at ``interpret=True``, bit for bit: the probe
bucketing, ``point_probe_partitioned`` and ``range_probe_partitioned`` at
the sizes of tests/test_kernels.py and tests/test_engine.py, the
``FilterOps`` tier switch, the budget knob and the façade's
``backend="partitioned"``.  Inputs come from a numpy seed; each reference
kernel runs once per block size for the whole module.  The CUDA launches
are tested in tests/test_torch_gpu.py, on a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import BloomRF as JBloomRF
from repro.core import basic_layout as jbasic
from repro.kernels import point_probe_partitioned as j_point
from repro.kernels import range_probe_partitioned as j_range
from repro.kernels.probe import _bucket_probes as j_bucket
from repro_torch.core import FilterLayout, basic_layout
from repro_torch.core.engine import _filter_for_layout
from repro_torch.kernels import (DEFAULT_BLOCK_U32, DEFAULT_TILE,
                                 DEFAULT_VMEM_BUDGET_U32, FilterOps,
                                 point_probe_partitioned,
                                 range_probe_partitioned)
from repro_torch.kernels.probe import _bucket_probes, point_partitioned_plain
from repro_torch.kernels.rangeprobe import range_partitioned_plain

_TILE = 128
_BLOCKS = (256, 2048)
_CPU = torch.device("cpu")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def _port(jl) -> FilterLayout:
    return FilterLayout.from_dict(dataclasses.asdict(jl))


@pytest.fixture(scope="module")
def case():
    """tests/test_kernels.py's and tests/test_engine.py's partitioned case:
    5,000 keys in ``basic_layout(32, 5000, 14.0, delta=6)``, point queries
    (300 present) and 900 ranges up to 2^12 wide; the reference's verdicts
    at both block sizes, computed once."""
    rng = np.random.default_rng(0x9A27)
    jl = jbasic(32, 5000, 14.0, delta=6)
    keys = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    jstate = JBloomRF(jl, _warn=False).build(jnp.asarray(keys))
    qs = np.concatenate([keys[:300], rng.integers(
        0, 1 << 32, 700, dtype=np.uint64).astype(np.uint32)])
    lo = rng.integers(0, 1 << 32, 900, dtype=np.uint64).astype(np.uint32)
    hi = np.maximum(lo, lo + rng.integers(0, 1 << 12, 900).astype(np.uint32))
    want_p = {b: np.asarray(j_point(jl, jstate, jnp.asarray(qs), _TILE, b,
                                    True)) for b in _BLOCKS}
    want_r = {b: np.asarray(j_range(jl, jstate, jnp.asarray(lo),
                                    jnp.asarray(hi), _TILE, b, True))
              for b in _BLOCKS}
    state = torch.from_numpy(np.asarray(jstate).view(np.int32).copy())
    return dict(lay=_port(jl), keys=keys, state=state, qs=qs, lo=lo, hi=hi,
                want_p=want_p, want_r=want_r)


def _lane_sets(rng):
    """Lane probes over 3,000 lanes: uniform; only the first and last
    blocks of the 2048-lane tiling (empty blocks between); all in one
    256-lane block."""
    return {
        "uniform": rng.integers(0, 3000, 777),
        "empty_blocks": np.concatenate([rng.integers(0, 100, 300),
                                        rng.integers(2900, 3000, 200)]),
        "one_block": rng.integers(512, 768, 640),
    }


@pytest.mark.parametrize("lanes", ["uniform", "empty_blocks", "one_block"])
@pytest.mark.parametrize("tile,block_u32", [(128, 256), (128, 2048),
                                            (512, 16384)])
def test_bucket_probes_matches_reference(tile, block_u32, lanes):
    lane = _lane_sets(np.random.default_rng(0xB0C7))[lanes].astype(np.int32)
    nblocks = (3000 + block_u32 - 1) // block_u32
    want = j_bucket(jnp.asarray(lane), tile, block_u32, nblocks)
    got = _bucket_probes(torch.from_numpy(lane.astype(np.int64)), tile,
                         block_u32, nblocks)
    assert got[4] == want[4]                   # capr, the worst case
    assert got[2].dtype == torch.int32 and got[3].dtype == torch.int32
    for g, w in zip(got[:4], want[:4]):        # order, slot, lane_b, tile_block
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("block_u32", _BLOCKS)
def test_point_probe_partitioned_matches_reference(case, block_u32):
    before = point_probe_partitioned.launches
    got = point_probe_partitioned(case["lay"], case["state"], _t(case["qs"]),
                                  _TILE, block_u32).numpy()
    assert point_probe_partitioned.launches == before   # CPU: no launch
    np.testing.assert_array_equal(got, case["want_p"][block_u32])
    assert got[:300].all()
    # the resident path and the engine agree with it
    eng = _filter_for_layout(case["lay"], _CPU).engine
    np.testing.assert_array_equal(
        eng.point_batched(case["state"], _t(case["qs"])).numpy(), got)


@pytest.mark.parametrize("block_u32", _BLOCKS)
def test_range_probe_partitioned_matches_reference(case, block_u32):
    lo, hi = _t(case["lo"]), _t(case["hi"])
    before = range_probe_partitioned.launches
    got = range_probe_partitioned(case["lay"], case["state"], lo, hi, _TILE,
                                  block_u32).numpy()
    assert range_probe_partitioned.launches == before
    np.testing.assert_array_equal(got, case["want_r"][block_u32])
    # swapped bounds answer the same; ranges around every key are positive
    np.testing.assert_array_equal(range_probe_partitioned(
        case["lay"], case["state"], hi, lo, _TILE, block_u32).numpy(), got)
    k = case["keys"].astype(np.int64)
    around = range_probe_partitioned(
        case["lay"], case["state"], _t(np.maximum(k - 2, 0)),
        _t(np.minimum(k + 2, (1 << 32) - 1)), _TILE, block_u32)
    assert around.all()


def test_partitioned_plain_covers_layout_classes():
    """Over the layout classes the resident kernels are swept on (several
    segments, W = 64 with replicas, d = 16, top level = d, an exact bitmap
    for points), with a block that does not divide the state: the plain
    partitioned path equals the engine."""
    rng = np.random.default_rng(0x9A28)
    layouts = [
        FilterLayout(d=32, deltas=(6, 5, 4), replicas=(2, 1, 2),
                     seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096)),
        FilterLayout(d=32, deltas=(7, 7), replicas=(1, 2),
                     seg_of_layer=(0, 0), seg_bits=(16384,)),
        basic_layout(16, 3000, 12.0, delta=3),
        basic_layout(32, 2, 16.0),
        FilterLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                     seg_of_layer=(2, 2, 1, 1),
                     seg_bits=(1 << 12, 4096, 8192), exact_seg=0),
    ]
    for lay in layouts:
        f = _filter_for_layout(lay, _CPU)
        top = (1 << lay.d) - 1
        keys = _t(rng.integers(0, top + 1, 2000, dtype=np.uint64))
        state = f.build(keys)
        qs = torch.cat([keys[:500], _t(rng.integers(0, top + 1, 500,
                                                    dtype=np.uint64))])
        block = 100 if lay.total_u32 > 100 else 3     # does not divide
        assert lay.total_u32 % block
        np.testing.assert_array_equal(
            point_partitioned_plain(lay, state, qs, 64, block).numpy(),
            f.engine.point_batched(state, qs).numpy())
        if lay.has_exact:
            continue
        lo = qs
        hi = torch.clamp(qs + _t(rng.integers(0, 1 << 10, len(qs))), max=top)
        np.testing.assert_array_equal(
            range_partitioned_plain(lay, state, lo, hi, 64, block).numpy(),
            f.engine.range_batched(state, lo, hi).numpy())


def test_partitioned_rejects_exact_layouts_and_bad_tiling():
    ex = FilterLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                      seg_of_layer=(2, 2, 1, 1),
                      seg_bits=(1 << 12, 4096, 8192), exact_seg=0)
    st = torch.zeros(ex.total_u32, dtype=torch.int32)
    lo = torch.arange(10, dtype=torch.int64)
    with pytest.raises(ValueError, match="exact-layer"):
        range_probe_partitioned(ex, st, lo, lo, 128, 256)
    with pytest.raises(ValueError, match="block_u32"):
        point_probe_partitioned(ex, st, lo, 128, 0)
    # empty batches answer empty
    assert point_probe_partitioned(ex, st, lo[:0]).shape == (0,)
    lay = basic_layout(32, 1000, 12.0, delta=6)
    st = torch.zeros(lay.total_u32, dtype=torch.int32)
    assert range_probe_partitioned(lay, st, lo[:0], lo[:0]).shape == (0,)
    assert (DEFAULT_TILE, DEFAULT_BLOCK_U32) == (512, 16384)


def test_filter_ops_partitioned_tier_equals_resident(case):
    lay = case["lay"]
    part, res = FilterOps(lay, vmem_budget_u32=1), FilterOps(lay)
    assert not part.resident and res.resident
    keys = _t(case["keys"])
    f = _filter_for_layout(lay, _CPU)
    sp = part.insert(f.init_state(), keys)
    np.testing.assert_array_equal(sp.numpy(), case["state"].numpy())
    qs, lo, hi = _t(case["qs"]), _t(case["lo"]), _t(case["hi"])
    np.testing.assert_array_equal(part.point(sp, qs).numpy(),
                                  res.point(sp, qs).numpy())
    np.testing.assert_array_equal(part.range(sp, lo, hi).numpy(),
                                  res.range(sp, lo, hi).numpy())


def test_vmem_budget_env_and_partitioned_backend(monkeypatch):
    """tests/test_facade.py's budget paths on the port: the env knob flips
    the tier, a per-instance budget beats it, and the façade's backend
    rides the same override."""
    lay = basic_layout(32, 200_000, 16.0, delta=6)
    monkeypatch.delenv("BLOOMRF_VMEM_BUDGET_U32", raising=False)
    assert FilterOps(lay).vmem_budget_u32 == DEFAULT_VMEM_BUDGET_U32
    monkeypatch.setenv("BLOOMRF_VMEM_BUDGET_U32", "64")
    ops = FilterOps(lay)
    assert ops.vmem_budget_u32 == 64 and not ops.resident
    assert FilterOps(lay, vmem_budget_u32=1 << 22).resident
    kw = dict(dtype="u32", n=200_000)
    h = repro_torch.open_filter(
        repro_torch.FilterSpec(backend="partitioned", **kw), device="cpu")
    assert h.ops is not None and not h.ops.resident
    h = repro_torch.open_filter(
        repro_torch.FilterSpec(backend="resident", **kw), device="cpu")
    assert h.ops is not None and h.ops.resident


def test_open_filter_partitioned_matches_reference():
    """The façade with ``backend="partitioned"`` against ``repro``'s on the
    same keys: the same state and verdicts."""
    rng = np.random.default_rng(0x9A29)
    kw = dict(dtype="u32", n=3000, range_log2=10)
    ref = repro.open_filter(repro.FilterSpec(backend="xla", **kw))
    port = repro_torch.open_filter(
        repro_torch.FilterSpec(backend="partitioned", **kw), device="cpu")
    assert not port.ops.resident
    keys = rng.integers(0, 1 << 32, 3000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 10, 1000, dtype=np.uint64),
                    (1 << 32) - 1)
    ref.insert(keys)
    port.insert(keys)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    qs = np.concatenate([keys[:500], lo[:500]])
    np.testing.assert_array_equal(port.point(qs), ref.point(qs))
    np.testing.assert_array_equal(port.range(lo, hi), ref.range(lo, hi))


def test_port_refuses_where_reference_positions_wrap():
    """Above 2^31 bits ``repro``'s int32 bit positions wrap negative
    (``BloomRF._positions_one``); the port refuses such a layout instead.
    ``basic_layout(32, 134_300_000, 16.0)`` is 2,148,800,000 bits: two of
    these 4,096 keys' positions come out negative in the reference."""
    import jax

    from repro_torch.core import BloomRF

    jl = jbasic(32, 134_300_000, 16.0)
    keys = np.random.default_rng(7).integers(
        0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
    f = JBloomRF(jl, _warn=False)
    pos = np.asarray(jax.vmap(f._positions_one)(jnp.asarray(keys)))
    assert (pos < 0).sum() == 2
    with pytest.raises(ValueError, match="does not fit"):
        BloomRF(_port(jl), device="cpu")
    # at exactly 2^31 bits the reference's positions all fit
    jl = jbasic(32, 1 << 27, 16.0)
    assert jl.total_bits == 1 << 31
    f = JBloomRF(jl, _warn=False)
    assert (np.asarray(jax.vmap(f._positions_one)(jnp.asarray(keys))) >= 0
            ).all()
