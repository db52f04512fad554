"""The port's deletable LSM store (``mutability="deletable"``) on the CPU
against ``repro``'s, on one seeded churn stream: about 40% of the ops
delete a live key (after the reference's tests/test_store_churn.py), with
a flush every 20 ops, so compaction meets sparse and dead-heavy runs and
takes all four merge branches (OR, promote, rebuild, purge).  Everything
must be equal: ``StoreStats``, every run's layout, level, promotions and
state bit for bit, and every ``get_many`` / ``scan_many`` answer.

The stream runs over 24-bit and over 64-bit keys.  One reference store
runs each once per module (its builds are JAX compiles); the port runs
each once per ``scan_backend``."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.core as rcore
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro.store import compaction as rcompaction
from repro_torch.core import dynamic
from repro_torch.core.layout import FilterLayout
from repro_torch.store import Store, StoreConfig
from repro_torch.store import compaction

# key width -> stream length: a 32-bit and a 64-bit carrier; the 64-bit
# reference builds are slower, so its stream is shorter and starts with
# puts alone, which its early merges need to promote
STREAMS = {24: dict(n_ops=3000), 64: dict(n_ops=500, warm=350)}
DS = list(STREAMS)
_CFG = dict(memtable_limit=128, level0_runs=2, fanout=4, bits_per_key=14.0,
            mutability="deletable", use_insert_kernels=True)


def _stream(d: int, seed: int = 0xC4021, n_ops: int = 3000,
            warm: int = 0):
    """The churn mix over ``d``-bit keys: puts of random keys (value: the
    op index) and, after the first ``warm`` ops, deletes of the oldest
    live key, 40% deletes, a flush every 20 ops; one ``delete_many`` sweep of 60 live keys, and a
    ``get_many`` (live keys and misses) plus a ``scan_many`` (near and
    random bounds, clipped to the domain) after every 1000 ops.  Returns
    the ops and the live model."""
    rng = np.random.default_rng(seed)
    space, top = 1 << d, np.uint64((1 << 64) - 1)
    model, ops = {}, []

    def reads():
        live = np.fromiter(model, np.uint64, len(model))
        keys = np.concatenate([rng.choice(live, 200),
                               rng.integers(0, space, 56, dtype=np.uint64)])
        lo = np.concatenate([np.maximum(rng.choice(live, 64), np.uint64(8))
                             - np.uint64(8),
                             rng.integers(0, space, 64, dtype=np.uint64)])
        hi = lo + np.minimum(rng.integers(0, 1 << 14, 128, dtype=np.uint64),
                             top - lo)
        return [("get", keys), ("scan", lo, hi)]

    for i in range(n_ops):
        if i >= warm and model and rng.random() < 0.4:
            k = next(iter(model))
            ops.append(("del", k))
            del model[k]
        else:
            k = int(rng.integers(0, space, dtype=np.uint64))
            ops.append(("put", k, i))
            model.pop(k, None)
            model[k] = i
        if i % 20 == 19:
            ops.append(("flush",))
        if i == n_ops // 2:
            sweep = list(model)[100:160]
            ops.append(("delm", np.asarray(sweep, np.uint64)))
            for k in sweep:
                del model[k]
        if i % (n_ops // 3) == n_ops // 3 - 1:
            ops += reads()
    ops.append(("flush",))
    return ops, model


def _drive(store, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2])
        elif op[0] == "del":
            store.delete(op[1])
        elif op[0] == "delm":
            store.delete_many(op[1])
        elif op[0] == "flush":
            store.flush()
        elif op[0] == "get":
            out.append(store.get_many(op[1]))
        else:
            out.append(store.scan_many(op[1], op[2]))
    return out


def _runs(store) -> list:
    return [(dataclasses.asdict(r.layout), r.level, r.promotions, r.keys,
             [None if t else v for v, t in zip(r.vals, r.tombs)], r.tombs,
             np.asarray(r.state_numpy() if hasattr(r, "state_numpy")
                        else r.state, np.uint32))
            for r in store.live_runs()]


@functools.lru_cache(maxsize=None)
def _reference(d: int):
    ops, model = _stream(d, **STREAMS[d])
    st = RStore(RConfig(d=d, scan_backend="xla", **_CFG), _warn=False)
    out = _drive(st, ops)
    return ops, model, out, st.stats.as_dict(), _runs(st), st


@functools.lru_cache(maxsize=None)
def _port(d: int, scan_backend: str):
    ops, *_ = _reference(d)
    st = Store(StoreConfig(d=d, scan_backend=scan_backend, **_CFG),
               device="cpu")
    out = _drive(st, ops)
    return out, st


@pytest.mark.parametrize("d", DS)
def test_stream_reaches_every_merge_branch(d):
    *_, stats, _, _ = _reference(d)
    assert stats["promote_merges"] >= 1 and stats["purge_rebuilds"] >= 1
    assert stats["or_merges"] >= 1 and stats["rebuild_merges"] >= 1


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("scan_backend", ["auto", "kernel", "xla"])
def test_churn_stream_matches_reference(scan_backend, d):
    _, model, want, want_stats, want_runs, _ = _reference(d)
    got, st = _port(d, scan_backend)
    assert got == want
    assert st.stats.as_dict() == want_stats
    assert st.filter_builds == st.stats.flushes + st.stats.rebuild_merges \
        + st.stats.purge_rebuilds
    got_runs = _runs(st)
    assert len(got_runs) == len(want_runs)
    for g, w in zip(got_runs, want_runs):
        assert g[0] == w[0] and g[1:3] == w[1:3] and g[4] == w[4]
        for a, b in zip(g[3:], w[3:]):
            if not isinstance(a, list):
                np.testing.assert_array_equal(a, b)
    assert any(r.promotions for r in st.live_runs()) \
        == any(w[2] for w in want_runs)


@pytest.mark.parametrize("d", DS)
def test_no_false_negatives_and_bounded_fpr(d):
    """The churn contract of the reference's test: every live key reads its
    last value, and the filters' positive rate on absent keys stays below
    0.30 after 40% deletes."""
    _, model, *_ = _reference(d)
    _, st = _port(d, "xla")
    live = np.fromiter(model, np.uint64, len(model))
    assert st.get_many(live) == [model[int(k)] for k in live]
    rng = np.random.default_rng(5)
    absent = rng.integers(0, 1 << d, 20_000, dtype=np.uint64)
    absent = absent[~np.isin(absent, live)]
    fence, filt = st.probe_runs(absent, absent, point=True)
    assert float((fence & filt).any(axis=1).mean()) < 0.30


@pytest.mark.parametrize("d", DS)
def test_promote_decisions_are_the_references(d):
    """The density guard's floats, the tiling factors and the promoted
    states of the store's class layouts equal the reference's exactly."""
    *_, ref = _reference(d)
    _, st = _port(d, "xla")
    for rr, pr in zip(ref.live_runs(), st.live_runs()):
        assert compaction._state_density(pr) == \
            rcompaction._state_density(rr)
    lays = [st.class_layout(st.class_capacity(c)) for c in range(4)]
    rlays = [ref.class_layout(ref.class_capacity(c)) for c in range(4)]
    for a in range(4):
        for b in range(4):
            assert dynamic.promotion_factors(lays[a], lays[b]) == \
                rcore.promotion_factors(rlays[a], rlays[b])
    src = max(ref.live_runs(), key=lambda r: r.layout.total_u32)
    lay = FilterLayout.from_dict(dataclasses.asdict(src.layout))
    target = dynamic.promote_layout(lay, 4)
    got = dynamic.promote_state(
        torch.from_numpy(np.asarray(src.state).view(np.int32).copy()),
        lay, target)
    want = rcore.promote_state(src.state, src.layout,
                               rcore.promote_layout(src.layout, 4))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    pr = max(st.live_runs(), key=lambda r: r.layout.total_u32)
    assert compaction._promotion_is_cheap([pr], target, len(pr), 1.5) == \
        rcompaction._promotion_is_cheap([src], rcore.promote_layout(
            src.layout, 4), len(src), 1.5)
