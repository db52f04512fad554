"""The filter banks and the prefix cache on a card, held to their plain
PyTorch paths on the same card, bit for bit: the insert kernel's row
builds (B1, one launch per row that owns keys) against the plain masked
build, the stacked point kernel (B6, one launch per probe, one per
65,535 rows above that) against the plain ``StackedProbe.point_all``,
ranges with no launch, the façade's
``bank`` and ``tenant`` handles against their ``backend="xla"`` twins, the
prefix cache against its CPU run, and the sharded banks on an NCCL world
of one.  Marked ``gpu``: they skip where no CUDA device is present, and
run with ``python -m pytest -m gpu tests/test_torch_bank_gpu.py``.  This
file imports neither ``jax`` nor ``repro``."""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import uint64 as u64
from repro_torch.dist import (FilterBank, ShardedFilterBank,
                              ShardedTenantFilterBank, TenantFilterBank)
from repro_torch.kernels import insert_resident, point_probe_stacked_resident
from repro_torch.serve import PrefixCacheIndex, pack_key

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card; decided here, never at import, so every pytest-xdist
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _counted():
    for fn in (insert_resident, point_probe_stacked_resident):
        fn.launches = 0
    return lambda: (insert_resident.launches,
                    point_probe_stacked_resident.launches)


def _data(d, n, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << d, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << d, n, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << (d - 3), n, dtype=np.uint64),
                    np.uint64((1 << d) - 1))
    return keys, lo, hi


@pytest.mark.parametrize("d,S", [(16, 1), (24, 4), (32, 8)])
def test_bank_kernels_equal_plain(cuda, d, S):
    keys, lo, hi = _data(d, 5000, d + S)
    kern = FilterBank(d, S, 5000, 14.0, device=cuda, _warn=False)
    plain = FilterBank(d, S, 5000, 14.0, device=cuda, use_kernels=False,
                       _warn=False)
    assert kern.kernels and not plain.kernels
    k, lo_t, hi_t = (u64.carrier(a, cuda) for a in (keys, lo, hi))
    read = _counted()
    st = kern.build(k)
    owners = len(np.unique(keys >> np.uint64(kern.d_local))) if S > 1 else 1
    assert read() == (owners, 0)
    want = plain.build(k)
    assert torch.equal(st, want)
    q = torch.cat([k[:2500], lo_t[:2500]])
    v = kern.point(st, q)
    assert read() == (owners, 1)
    hits = point_probe_stacked_resident(kern.layout, st, q)
    assert torch.equal(hits, kern._stacked.point_all(st.reshape(-1), q))
    assert torch.equal(v, plain.point(want, q)) and bool(v[:2500].all())
    _counted()
    assert torch.equal(kern.range(st, lo_t, hi_t), plain.range(want, lo_t,
                                                                hi_t))
    assert read() == (0, 0)


def test_tenant_bank_kernels_equal_plain(cuda):
    keys, lo, hi = _data(32, 6000, 3)
    rng = np.random.default_rng(4)
    ten = torch.from_numpy(rng.integers(0, 5, 6000)).to(cuda)  # 4: nobody
    kern = TenantFilterBank(32, 4, 4, 1500, 14.0, device=cuda, _warn=False)
    plain = TenantFilterBank(32, 4, 4, 1500, 14.0, device=cuda,
                             use_kernels=False, _warn=False)
    k, lo_t, hi_t = (u64.carrier(a, cuda) for a in (keys, lo, hi))
    read = _counted()
    st, me = kern.build(ten, k)
    assert read() == (2 * 16, 0)      # every main and meta row owns keys
    ws, wm = plain.build(ten, k)
    assert torch.equal(st, ws) and torch.equal(me, wm)
    v = kern.point(st, ten, k)
    assert read() == (32, 1)
    assert torch.equal(v, plain.point(ws, ten, k))
    assert bool(v[ten < 4].all()) and not bool(v[ten == 4].any())
    _counted()
    for meta in (None, me):
        assert torch.equal(kern.range(st, ten, lo_t, hi_t, meta),
                           plain.range(ws, ten, lo_t, hi_t,
                                       None if meta is None else wm))
    assert read() == (0, 0)


def test_banks_of_more_rows_than_one_launch_takes(cuda):
    """65,536 rows, one more than the stacked point kernel's row grid: B1
    builds every row that owns keys and B6 answers in two launches, both
    equal to the plain paths, through the bank and the façade."""
    rng = np.random.default_rng(9)
    ten_np = rng.integers(0, 16384, 20000)
    keys = rng.integers(0, 1 << 32, 20000, dtype=np.uint64)
    ten, k = torch.from_numpy(ten_np).to(cuda), u64.carrier(keys, cuda)
    kern, plain = (TenantFilterBank(32, 16384, 4, 64, 14.0, device=cuda,
                                    use_kernels=u, _warn=False)
                   for u in (True, False))
    owners = len(np.unique(ten_np * 4 + (keys >> np.uint64(30))))
    read = _counted()
    st, me = kern.build(ten, k)
    assert read() == (2 * owners, 0)
    ws, wm = plain.build(ten, k)
    assert torch.equal(st, ws) and torch.equal(me, wm)
    v = kern.point(st, ten[:256], k[:256])
    assert read() == (2 * owners, 2)
    assert torch.equal(v, plain.point(ws, ten[:256], k[:256]))
    assert bool(v.all())
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", n=64, placement="tenant", tenants=16384, shards=4))
    h.insert(ten_np.astype(np.uint32), keys)
    np.testing.assert_array_equal(h.state_numpy(),
                                  st.cpu().numpy().view(np.uint32))
    _counted()
    assert h.point(ten_np[:256].astype(np.uint32), keys[:256]).all()
    assert read() == (0, 2)


def test_facade_handles_equal_xla_twins(cuda):
    keys, lo, hi = _data(32, 20000, 5)
    ten = np.random.default_rng(6).integers(0, 8, 20000).astype(np.uint32)
    for kw in (dict(placement="bank", shards=4),
               dict(placement="tenant", tenants=8, shards=2),
               dict(placement="tenant", tenants=8, mutability="ttl")):
        h, x = (repro_torch.open_filter(repro_torch.FilterSpec(
            dtype="u32", n=20000, backend=b, chunk=4096, **kw))
            for b in ("auto", "xla"))
        args = (keys,) if kw["placement"] == "bank" else (ten, keys)
        rargs = (lo, hi) if kw["placement"] == "bank" else (ten, lo, hi)
        read = _counted()
        for f in (h, x):
            f.insert(*args)
        assert read()[0] > 0
        np.testing.assert_array_equal(h.state_numpy(), x.state_numpy())
        _counted()
        assert h.point(*args).all()
        assert read()[1] == 5                 # one launch per chunk
        np.testing.assert_array_equal(h.range(*rargs), x.range(*rargs))
        assert read()[1] == 5
        if kw.get("mutability") == "ttl":
            for f in (h, x):
                f.advance_generation()
                f.grow(2)
            np.testing.assert_array_equal(h.meta_numpy(), x.meta_numpy())


def test_prefix_cache_equals_cpu_run(cuda):
    def run(device):
        idx = PrefixCacheIndex(n_tenants=16, ttl_generations=2,
                               device=device)
        rng = np.random.default_rng(7)
        out = []
        for _ in range(4):
            ses = rng.choice(2000, 64, replace=False)
            idx.freeze_segment({pack_key(int(s), c): [int(s)]
                                for s in ses for c in range(8)})
        out += [idx.lookup(int(s), 3) for s in rng.integers(0, 2000, 200)]
        out.append(idx.evict_window(0, 500))
        out.append(idx.advance_generation())
        return out, idx.stats

    read = _counted()
    assert run(cuda) == run("cpu")
    assert read()[1] == 200               # one launch per lookup


def test_sharded_banks_on_an_nccl_world_of_one(cuda, tmp_path):
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        keys, lo, hi = _data(32, 4000, 8)
        k, lo_t, hi_t = (u64.carrier(a, cuda) for a in (keys, lo, hi))
        bank = FilterBank(32, 8, 4000, 14.0, device=cuda, _warn=False)
        sb = ShardedFilterBank(bank)
        st = sb.build(k)
        assert torch.equal(st, bank.build(k))
        assert torch.equal(sb.point(st, k), bank.point(st, k))
        assert torch.equal(sb.range(st, lo_t, hi_t), bank.range(st, lo_t,
                                                                hi_t))
        ten = k % 4
        tb = TenantFilterBank(32, 4, 2, 1000, 14.0, device=cuda, _warn=False)
        stb = ShardedTenantFilterBank(tb)
        s, m = stb.build(ten, k)
        ws, wm = tb.build(ten, k)
        assert torch.equal(s, ws) and torch.equal(m, wm)
        assert torch.equal(stb.range(s, ten, lo_t, hi_t, m),
                           tb.range(ws, ten, lo_t, hi_t, wm))
    finally:
        dist.destroy_process_group()
