"""The port's LSM store (``repro_torch.store``) on the CPU against ``repro``'s
store, on one seeded op stream: the same scan and get results, the same
``StoreStats``, the same live-run layouts and bit-identical run states.

One reference store (``scan_backend="xla"``) runs the stream once per
module; its answers are shared by every test below, so the reference's
JAX compiles are paid once.  The port runs the stream under each
``scan_backend``: on the CPU ``"auto"`` and ``"xla"`` take the plain
``StackedProbe`` and ``"kernel"`` takes the store-scan wrapper's plain
version.  The CUDA launches are tested in tests/test_torch_gpu.py and
``chip_smoke.py``, on a card."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.store import Run as RRun
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro_torch.core.layout import FilterLayout
from repro_torch.store import (FaultPlan, InjectedCrash, InjectedDispatchFault,
                               Run, Store, StoreConfig, merge_filter_state)
from repro_torch.store import store as store_mod

#: the reference builds filters with its insert kernel (interpret mode),
#: which compiles once per key-batch shape instead of once per primitive;
#: the port's builds take its insert kernel under any config (on the CPU
#: its plain version, BloomRF.insert)
_CFG = dict(memtable_limit=64, level0_runs=2, fanout=2,
            use_insert_kernels=True)
DMAX = (1 << 32) - 1


def _stream(seed: int = 0x5701E):
    """~3000 ops over a pool of 3000 keys (so some puts overwrite and some
    deletes hit): 1200 puts and single deletes, one ``delete_many`` of 60,
    two ``get_many`` batches of 512 and three ``scan_many`` batches of 256,
    and a run quarantined before the last scans.  The scans meet stacks of
    two and three layouts (and the memtable); their bounds include ranges
    past the domain, ``lo`` above it, point scans and near misses."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, DMAX, 3000, dtype=np.uint64)

    def scans():
        lo = rng.integers(0, DMAX, 256, dtype=np.uint64)
        near = rng.random(256) < 0.3
        lo[near] = np.minimum(pool[rng.integers(0, 3000, near.sum())]
                              + rng.integers(1, 1 << 12, near.sum(),
                                             dtype=np.uint64), DMAX)
        hi = lo + rng.integers(0, 1 << 26, 256, dtype=np.uint64)
        hi[:4] = DMAX + np.uint64(7)            # past the domain: clamped
        lo[4:6] = hi[4:6] = DMAX + np.uint64(1)  # wholly above the domain
        lo[6:10] = hi[6:10] = pool[:4]           # point scans of stored keys
        return ("scan", lo, hi)

    def gets():
        return ("get", np.concatenate([pool[rng.integers(0, 3000, 384)],
                                       rng.integers(0, DMAX, 128,
                                                    dtype=np.uint64)]))

    ops = []
    for phase in range(2):
        for i in range(800 if phase == 0 else 400):
            if rng.random() < 0.1:
                ops.append(("del", int(pool[rng.integers(0, 3000)])))
            else:
                ops.append(("put", int(pool[rng.integers(0, 3000)]),
                            int(rng.integers(0, 1 << 30))))
        if phase == 0:
            ops.append(("delm", pool[rng.integers(0, 3000, 60)]))
            ops += [gets(), scans()]
    ops += [gets(), scans(), ("quarantine", 1), scans()]
    return ops


def _drive(store, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2])
        elif op[0] == "del":
            store.delete(op[1])
        elif op[0] == "delm":
            store.delete_many(op[1])
        elif op[0] == "get":
            out.append(store.get_many(op[1]))
        elif op[0] == "scan":
            out.append(store.scan_many(op[1], op[2]))
        else:                                   # a run's filter block "rots"
            store.live_runs()[op[1]].quarantined = True
            store._dirty = True
    return out


def _runs(store) -> list:
    """Each live run as plain data; a tombstone's value slot as None (each
    package has its own sentinel object)."""
    return [(dataclasses.asdict(r.layout), r.level, r.keys,
             [None if t else v for v, t in zip(r.vals, r.tombs)], r.tombs,
             None if r.state is None else np.asarray(
                 r.state_numpy() if hasattr(r, "state_numpy") else r.state,
                 np.uint32))
            for r in store.live_runs()]


@functools.lru_cache(maxsize=None)
def _reference():
    st = RStore(RConfig(scan_backend="xla", **_CFG), _warn=False)
    out = _drive(st, _stream())
    return out, st.stats.as_dict(), _runs(st), st


@pytest.mark.parametrize("scan_backend", ["auto", "kernel", "xla"])
def test_op_stream_matches_reference(scan_backend):
    want, want_stats, want_runs, _ = _reference()
    # the stream reaches both merge kinds and the quarantine path
    assert want_stats["or_merges"] > 0 and want_stats["rebuild_merges"] > 0
    assert want_stats["degraded_probes"] > 0
    st = Store(StoreConfig(scan_backend=scan_backend, **_CFG), device="cpu")
    assert _drive(st, _stream()) == want
    assert st.stats.as_dict() == want_stats
    got_runs = _runs(st)
    assert len(got_runs) == len(want_runs)
    for (gl, glv, gk, gv, gt, gs), (wl, wlv, wk, wv, wt, ws) in zip(
            got_runs, want_runs):
        assert gl == wl and glv == wlv and gv == wv
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)


def test_default_config_builds_through_the_insert_kernel(monkeypatch):
    """Without ``use_insert_kernels`` (the façade's config) every flush and
    rebuild goes through ``insert_resident`` (its plain version on the
    CPU; one launch on a CUDA store), and the run states still equal the
    reference store's."""
    _, _, want_runs, _ = _reference()
    calls = []
    real = store_mod.insert_resident

    def counting(layout, state, keys):
        calls.append(len(keys))
        return real(layout, state, keys)

    monkeypatch.setattr(store_mod, "insert_resident", counting)
    cfg = {k: v for k, v in _CFG.items() if k != "use_insert_kernels"}
    st = Store(StoreConfig(**cfg), device="cpu")
    assert not st.cfg.use_insert_kernels
    _drive(st, _stream())
    assert st.filter_builds == len(calls) > 0
    assert st.filter_builds == st.stats.flushes + st.stats.rebuild_merges \
        + st.stats.purge_rebuilds
    got_runs = _runs(st)
    assert len(got_runs) == len(want_runs)
    for got, want in zip(got_runs, want_runs):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[5], want[5])


def test_runs_unpack_across_packages():
    """A ``repro`` run's snapshot unpacks in the port (state on the CPU as
    int32 lanes, the quarantine flag and checksums carried) and the port's
    snapshot of it unpacks in ``repro``, equal field for field."""
    *_, ref = _reference()
    rr = ref.live_runs()[-1]
    rr.quarantined = True
    try:
        enc = rr.pack()
    finally:
        rr.quarantined = False
    run = Run.unpack(enc, device="cpu")
    assert run.layout == FilterLayout.from_dict(dataclasses.asdict(rr.layout))
    assert run.quarantined and run.state.dtype == torch.int32
    np.testing.assert_array_equal(run.state_numpy(), np.asarray(rr.state))
    # the component checksums agree across the packages
    assert run.checksums() == rr.checksums()
    assert all(run.verify().values())
    assert run.lookup(int(rr.keys[3]))[0]
    back = RRun.unpack(run.pack())
    assert back.quarantined and back.checksums() == rr.checksums()
    np.testing.assert_array_equal(np.asarray(back.state), np.asarray(rr.state))
    with pytest.raises(ValueError, match="layout"):
        Run.unpack(dict(enc, layout={"d": 32}), device="cpu")


def _small_store(**kw) -> Store:
    st = Store(StoreConfig(**_CFG, **kw), device="cpu")
    for k in range(0, 1 << 20, 1 << 12):
        st.put(k, k)
    return st


def test_dispatch_fault_auto_retries_on_the_plain_path():
    los = np.asarray([0, 1 << 16], np.uint64)
    his = los + (1 << 14)
    want = _small_store().scan_many(los, his)
    st = _small_store(scan_backend="auto")
    st.faults = FaultPlan(fail_pallas=1)
    st._scan_kernel_mode = lambda: "kernel"     # CPU "auto" would pick plain
    assert st.scan_many(los, his) == want       # absorbed by the plain path
    assert st.stats.kernel_fallbacks == 1
    assert st.scan_many(los, his) == want       # the plan is spent: no retry
    assert st.stats.kernel_fallbacks == 1
    lo_t = torch.tensor([0, 1 << 16])
    st.faults = FaultPlan(fail_pallas=1)
    fence, touch = st.scan_probe_device(lo_t, lo_t + (1 << 14))
    assert st.stats.kernel_fallbacks == 2 and touch.shape == fence.shape


def test_dispatch_fault_propagates_when_kernel_is_pinned():
    st = _small_store(scan_backend="kernel")
    st.faults = FaultPlan(fail_pallas=1)
    with pytest.raises(InjectedDispatchFault):
        st.scan_many([0], [100])
    assert st.stats.kernel_fallbacks == 0


def test_a_real_kernel_error_is_never_retried(monkeypatch):
    """Only the fault seam's own exception is absorbed: a kernel that fails
    to build or launch surfaces, under "auto" too."""
    def broken(*a, **k):
        raise RuntimeError("nvcc failed for store_scan.cu")

    monkeypatch.setattr(store_mod, "store_scan_probe_flat", broken)
    st = _small_store(scan_backend="auto")
    st._scan_kernel_mode = lambda: "kernel"
    with pytest.raises(RuntimeError, match="nvcc failed"):
        st.scan_many([0], [100])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        st.scan_probe_device(torch.tensor([0]), torch.tensor([100]))
    assert st.stats.kernel_fallbacks == 0


def test_crash_before_swap_leaves_the_sources_live():
    """Compaction builds the merged run before it swaps the levels, so a
    crash at the seam leaves every source run in place and scans exact."""
    st = Store(StoreConfig(**_CFG), device="cpu",
               faults=FaultPlan(crashes={"compact.before_swap": 1}))
    keys = list(range(0, 64 * 3 << 10, 1 << 10))
    with pytest.raises(InjectedCrash):
        for k in keys:
            st.put(k, k)
    assert len(st.levels[0]) == 3 and st.stats.compactions == 0
    assert st.scan(0, keys[-1]) == [(k, k) for k in keys]


@pytest.mark.parametrize("scan_backend", ["kernel", "xla"])
def test_u16_scans_clamp_bounds_to_the_domain(scan_backend):
    """d = 16: bounds past the domain are clamped on the host and scans
    wholly above it are fenced off, on both scan planes."""
    st = Store(StoreConfig(d=16, memtable_limit=64, level0_runs=2, fanout=2,
                           scan_backend=scan_backend), device="cpu")
    keys = np.random.default_rng(4).choice(1 << 16, 500, replace=False)
    for k in keys:
        st.put(int(k), int(k))
    lo = np.asarray([0, 60_000, 65_535, 65_536, 1 << 40], np.uint64)
    hi = np.asarray([1 << 20, 1 << 33, 65_535, 1 << 20, 1 << 41], np.uint64)
    want = [[(int(k), int(k)) for k in np.sort(keys) if a <= k <= b]
            for a, b in zip(lo, hi)]
    assert st.scan_many(lo, hi) == want
    assert want[0] and want[1] and not want[3] and not want[4]


def _typed_pair(dtype):
    kw = dict(dtype=dtype, placement="store", memtable_limit=128,
              level0_runs=4, fanout=2, backend="xla")
    return (repro.open_filter(repro.FilterSpec(**kw)),
            repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                    device="cpu"))


@pytest.mark.parametrize("dtype", ["u32", "f32"])
def test_typed_store_scans_decode_as_reference(dtype):
    rng = np.random.default_rng(3)
    if dtype == "u32":
        keys = rng.integers(0, DMAX, 200, dtype=np.uint64)
        lo = rng.integers(0, DMAX, 64, dtype=np.uint64)
        hi = np.minimum(lo + np.uint64(1 << 28), np.uint64(DMAX))
        as_key = int
    else:
        keys = rng.normal(0, 1e3, 200).astype(np.float32)
        lo = rng.normal(0, 1e3, 64).astype(np.float32)
        hi = lo + np.float32(300.0)
        as_key = float
    ref, port = _typed_pair(dtype)
    for i, k in enumerate(keys):
        ref.put(as_key(k), i)
        port.put(as_key(k), i)
    got = port.scan_many(lo, hi)
    assert got == ref.scan_many(lo, hi)
    assert sum(map(len, got)) > 0
    assert port.get_many(keys[:20]) == ref.get_many(keys[:20])
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.n_runs == ref.n_runs and port.size_bits() == ref.size_bits()
    # the device plane on encoded bounds equals the host plane's masks
    clo, chi = port.encode_scan_bounds(lo, hi)
    assert clo.dtype == torch.int64 and clo.device.type == "cpu"
    fence, touch = port.scan_probe_device(clo, chi)
    f2, t2 = port.store._touch_masks(*port.codec.encode_bounds(lo, hi))
    np.testing.assert_array_equal(fence.numpy(), f2)
    np.testing.assert_array_equal(touch.numpy(), t2)


@pytest.mark.parametrize("make,item", [
    (lambda pkg, **kw: pkg.open_filter(pkg.FilterSpec(
        dtype="u32", placement="bank", shards=2), **kw), "A.9"),
    (lambda pkg, **kw: pkg.open_filter(pkg.FilterSpec(
        dtype="u32", placement="tenant", tenants=2, tuning="adaptive"),
        **kw), "A.9"),
])
def test_deferred_features_raise_naming_their_item(make, item):
    """The bank and tenant placements of ROADMAP ``item`` (they raised
    before it was ported) open and build the state ``repro`` builds."""
    ref, port = make(repro), make(repro_torch, device="cpu")
    keys = np.random.default_rng(0xA9).integers(0, 1 << 32, 400,
                                                dtype=np.uint64)
    args = (keys,) if port.spec.placement == "bank" else (1, keys)
    for h in (ref, port):
        h.insert(*args)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    assert port.point(*args).all() and ref.point(*args).all()


def test_store_config_validation_matches_reference(monkeypatch):
    for bad in (dict(d=0), dict(d=65), dict(bits_per_key=0.0),
                dict(mutability="append_only"), dict(purge_dead_frac=1.5),
                dict(scan_backend="tpu"), dict(filter_backend="nope"),
                dict(durability="wal"), dict(fanout=1),
                dict(tuning="adaptive", filter_backend="none")):
        with pytest.raises(ValueError):
            RConfig(**bad)
        with pytest.raises(ValueError):
            StoreConfig(**bad)
    assert [f.name for f in dataclasses.fields(StoreConfig)] == \
        [f.name for f in dataclasses.fields(RConfig)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Store(StoreConfig(), device=dev)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32",
                                                       placement="store"))
