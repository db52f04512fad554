"""The port's workload-adaptive tuner (``tune/``) and the adaptive store on
the CPU against ``repro``'s, with exact equality: the tuner's floats come
from the same numpy operations on the same samples, so every score, win,
decision, event and ``retune_report()`` must be equal, and the adaptive
store's twin stream (the reference's ``tests/test_tune.py::_skewed_ops`` at
its own size) must leave bit-identical run states.

Reference stores run once per module, their filter builds under
``jax.jit`` (:func:`_fast_builds`); the layouts are reused across tests.
Inputs come from local numpy generators, never from the shared ``rng``
fixture of conftest.py."""
import dataclasses
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
from repro.core import basic_layout as rbasic
from repro.core.engine import _filter_for_layout as _rfilter
from repro.obs.fpr import FprSampler as RSampler
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro.tune import AdaptiveTuner as RTuner
from repro.tune import Hysteresis as RHyst
from repro.tune import WorkloadModel as RModel
from repro.tune import candidate_layouts as rcands
from repro.tune import cross_check as rcross
from repro.tune import fit_workload as rfit
from repro.tune import score_layout as rscore
from repro.tune import solve as rsolve
from repro.tune.cost import words_per_range_query as rwords
from repro_torch.core.layout import FilterLayout, basic_layout
from repro_torch.obs.fpr import FprSampler
from repro_torch.store import Store, StoreConfig
from repro_torch.tune import (AdaptiveTuner, Hysteresis, WorkloadModel,
                              candidate_layouts, cross_check, fit_workload,
                              score_layout, solve)
from repro_torch.tune.cost import words_per_range_query


def _port(lay) -> FilterLayout:
    """The port's layout equal to a reference layout."""
    return FilterLayout.from_dict(dataclasses.asdict(lay))


def _asdict(lay) -> dict:
    return {k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in dataclasses.asdict(lay).items()}


@functools.lru_cache(maxsize=None)
def _jit_build(layout):
    return jax.jit(_rfilter(layout).build)


def _fast_builds(store):
    """The reference store's own ``BloomRF.build`` under ``jax.jit``, its
    keys padded to a power of two by repeating the first key (setting the
    same bits twice leaves the state as it is): one compile per layout and
    size class instead of one per primitive and key count.  The run states
    are compared with the port's bit for bit, so a difference would show."""
    def build(layout, keys):
        keys = np.asarray(keys)
        n = 1 << max(int(len(keys) - 1).bit_length(), 4)
        keys = np.concatenate([keys, np.full(n - len(keys), keys[0],
                                             keys.dtype)])
        return _jit_build(layout)(jnp.asarray(keys, store.kdtype))

    store._build_filter = build
    return store


def _ranges(seed=21, n=400, length=64, d=32):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << min(d, 24), n, dtype=np.uint64)
    keys = rng.integers(0, 1 << d, 2000, dtype=np.uint64)
    return lo, lo + np.uint64(length - 1), keys


def _models(length=64, n=400, d=32, seed=21):
    """The same fitted workload in both packages."""
    lo, hi, keys = _ranges(seed, n, length, d)
    out = []
    for sampler, fit in ((RSampler, rfit), (FprSampler, fit_workload)):
        s = sampler(d, seed=seed)
        s.observe_ranges(lo, hi)
        out.append(fit(d, sampler=s, keys=keys, observed={"range_fpr": 0.02},
                       n_points=100))
    return out


# layouts the cost and solver tests share: the class ladders of a store and
# the candidates around one of them
_LADDERS = [(24, 4000, 12.0, 2), (32, 8000, 12.0, 6), (32, 20_000, 14.0, 6),
            (32, 800, 14.0, 6), (32, 51_200, 14.0, 6)]


# ---------------------------------------------------------------------------
# WorkloadModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,d", [(64, 32), (8, 24), (1 << 14, 32)])
def test_workload_fit_and_serde_equal_the_reference(length, d):
    ref, port = _models(length=length, d=d)
    enc = port.to_dict()
    assert enc == ref.to_dict()
    assert port.point_frac() == ref.point_frac()
    assert port.c_factor == ref.c_factor
    np.testing.assert_array_equal(port.range_weights(), ref.range_weights())
    np.testing.assert_array_equal(port.rescaled(-2).range_log2,
                                  ref.rescaled(-2).range_log2)
    # each package reads the other's serialized model
    wire = pickle.loads(pickle.dumps(enc))
    assert RModel.from_dict(wire).to_dict() == enc
    assert WorkloadModel.from_dict(ref.to_dict()).to_dict() == enc
    # and refuses the same malformed ones
    for bad in (dict(enc, schema="bloomrf-workload/v9"), dict(enc, d=0),
                dict(enc, reservoir=[[5, 2]]), dict(enc, n_points=True)):
        with pytest.raises(ValueError):
            RModel.from_dict(bad)
        with pytest.raises(ValueError):
            WorkloadModel.from_dict(bad)


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ladder", _LADDERS)
def test_score_layout_and_cross_check_equal_the_reference(ladder):
    d, n, bpk, delta = ladder
    ref_m, port_m = _models(length=16, d=d)
    rlay = rbasic(d, n, bpk, delta=delta)
    play = _port(rlay)
    assert words_per_range_query(play) == rwords(rlay)
    for lay_r in [rlay] + rcands(rlay, n):
        lay_p = _port(lay_r)
        assert score_layout(lay_p, n, port_m).as_dict() == \
            rscore(lay_r, n, ref_m).as_dict()
    assert cross_check(play, n, port_m) == rcross(rlay, n, ref_m)


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ladder", _LADDERS)
def test_candidates_and_solve_equal_the_reference(ladder):
    d, n, bpk, delta = ladder
    rlay = rbasic(d, n, bpk, delta=delta)
    play = _port(rlay)
    assert play == basic_layout(d, n, bpk, delta=delta)
    assert [_asdict(c) for c in candidate_layouts(play, n)] == \
        [_asdict(c) for c in rcands(rlay, n)]
    for length in (8, 256, 1 << 12):
        ref_m, port_m = _models(length=length, d=d, n=500)
        for hyst in ((), (0.9999, 2, 64), (0.0, 0, 0), (0.1, 2, 1000)):
            rd = rsolve(ref_m, n, rlay, RHyst(*hyst))
            pd = solve(port_m, n, play, Hysteresis(*hyst))
            assert _asdict(pd.layout) == _asdict(rd.layout)
            assert (pd.changed, pd.win, pd.n_candidates, pd.reason) == \
                (rd.changed, rd.win, rd.n_candidates, rd.reason)
            assert pd.baseline.as_dict() == rd.baseline.as_dict()
            assert pd.best.as_dict() == rd.best.as_dict()


# ---------------------------------------------------------------------------
# AdaptiveTuner
# ---------------------------------------------------------------------------

def _tuner_stream(tuner, ladders, seed=31):
    """Observe scans and points in rounds, consulting every ladder after
    each round: the decisions, cache hits and cooldowns of a store."""
    rng = np.random.default_rng(seed)
    seen = []
    for rnd in range(6):
        length = (8, 8, 64, 4096, 8, 2)[rnd]
        lo = rng.integers(0, 1 << 24, 48, dtype=np.uint64)
        tuner.observe_scan(lo, lo + np.uint64(length - 1))
        tuner.observe_points(int(rng.integers(0, 50)))
        if rnd == 3:
            tuner.record_observed({"range_fpr": 0.03, "point_fpr": 0.01,
                                   "range_candidates": 7})
        for lay, n in ladders:
            got = tuner.advise_layout(lay, n)
            seen.append((_asdict(got), _asdict(tuner.cached_layout(lay))
                         if tuner.cached_layout(lay) is not None else None))
    return seen


def test_adaptive_tuner_events_equal_the_reference():
    rl = [(rbasic(32, n, 14.0, delta=6), n) for n in (800, 3200, 12_800)]
    pl = [(_port(lay), n) for lay, n in rl]
    ref = RTuner(32, hysteresis=RHyst(cooldown=2))
    port = AdaptiveTuner(32, hysteresis=Hysteresis(cooldown=2))
    assert _tuner_stream(port, pl) == _tuner_stream(ref, rl)
    assert port.retunes == ref.retunes >= 1
    assert port.events == ref.events
    assert port.report() == ref.report()
    assert port.to_dict() == ref.to_dict()
    assert port.cross_check(pl[-1][0], 12_800) == \
        ref.cross_check(rl[-1][0], 12_800)
    # each reloads the other's model
    back = AdaptiveTuner(32)
    back.load(ref.to_dict())
    assert back.to_dict() == ref.to_dict()
    rback = RTuner(32)
    rback.load(port.to_dict())
    assert rback.to_dict() == port.to_dict()
    with pytest.raises(ValueError, match="d=32"):
        AdaptiveTuner(24).load(port.to_dict())


# ---------------------------------------------------------------------------
# the adaptive store: the reference's twin stream at its own size
# ---------------------------------------------------------------------------

def _skewed_ops(seed, n_keys=12_000, n_scans=384, scan_len=256):
    """The reference's clustered keys and short near-miss scans
    (``tests/test_tune.py::_skewed_ops``)."""
    rng = np.random.default_rng(seed)
    keys = ((rng.random(n_keys) ** 4) * (1 << 31)).astype(np.uint64)
    keys += rng.integers(0, 1 << 22, n_keys, dtype=np.uint64)
    keys = np.minimum(keys, (1 << 32) - 1)
    starts = keys[rng.integers(0, n_keys, n_scans)] + np.uint64(1)
    starts = np.minimum(starts, (1 << 32) - np.uint64(scan_len))
    return keys, starts, starts + np.uint64(scan_len - 1)


def _drive(h, keys, slo, shi):
    """Half the keys, the scans in batches of 64, the other half; then
    point reads of every distinct key."""
    half = len(keys) // 2
    for i, k in enumerate(keys[:half]):
        h.put(int(k), i)
    h.flush()
    scans = []
    for s in range(0, len(slo), 64):
        scans.extend(h.scan_many(slo[s:s + 64], shi[s:s + 64]))
    for i, k in enumerate(keys[half:]):
        h.put(int(k), half + i)
    h.flush()
    return scans, h.get_many(np.unique(keys))


_TWIN = dict(dtype="u32", placement="store", memtable_limit=800,
             level0_runs=3, fanout=4, bits_per_key=14.0, delta=6)


@functools.lru_cache(maxsize=None)
def _reference_twin():
    keys, slo, shi = _skewed_ops(0xA5EED)
    h = repro.open_filter(repro.FilterSpec(tuning="adaptive", **_TWIN))
    _fast_builds(h.store)
    out = _drive(h, keys, slo, shi)
    return out, h


def _runs(store):
    return [(_asdict(r.layout), r.level, r.promotions, r.keys.tobytes(),
             np.asarray(r.state).view(np.uint32).tobytes()
             if not hasattr(r, "state_numpy") else
             r.state_numpy().tobytes())
            for r in store.live_runs()]


@functools.lru_cache(maxsize=None)
def _port_twin(tuning: str):
    keys, slo, shi = _skewed_ops(0xA5EED)
    h = repro_torch.open_filter(repro_torch.FilterSpec(tuning=tuning, **_TWIN),
                                device="cpu")
    return _drive(h, keys, slo, shi), h


def test_adaptive_twin_stream_equals_the_reference():
    want, ref = _reference_twin()
    got, port = _port_twin("adaptive")
    assert got == want
    keys, slo, shi = _skewed_ops(0xA5EED)
    st = port.stats.as_dict()
    assert st == ref.stats.as_dict() and st["retunes"] >= 1
    assert _runs(port.store) == _runs(ref.store)
    # the live stack holds tuner-chosen layouts, not only the ladder's
    assert any(r.layout != port.store.class_layout(len(r))
               for r in port.store.live_runs())
    assert port.retune_report() == ref.retune_report()
    # the observed FPR closes the loop into the cross-check
    out = port.observed_fpr()
    cc = port.retune_report()["cross_check"]
    assert cc["observed_range_fpr"] == out["range_fpr"]
    assert cc["calibration"] is None or 0.25 <= cc["calibration"] <= 4.0
    # the scan plane under the kernel mode (its plain version on the CPU)
    # prunes the tuned stack exactly as the host plane does
    snap = port.store.snapshot(flush_first=False)
    snap["config"] = dict(snap["config"], scan_backend="kernel")
    twin = Store.restore(snap, device="cpu")
    assert twin.live_runs() and twin._scan_kernel_mode() == "kernel"
    assert twin._tuner.to_dict() == port.store._tuner.to_dict()
    f1, t1 = twin._touch_masks(slo, shi)
    fence, filt = port.store.probe_runs(slo, shi)
    np.testing.assert_array_equal(f1, fence)
    np.testing.assert_array_equal(t1, fence & filt)


def test_static_store_reports_a_stub_and_a_twin_that_leaks_more():
    """The static twin answers the same scans, reports no retunes, and
    leaks more absent-range false positives than the adaptive store, as
    the reference's acceptance test asserts."""
    want, static = _port_twin("auto")
    got, adaptive = _port_twin("adaptive")
    assert got == want
    assert static.retune_report() == {"tuning": "auto", "retunes": 0,
                                      "events": []}
    keys, _, _ = _skewed_ops(0xA5EED)
    rng = np.random.default_rng(0xF00)
    lo = rng.integers(1 << 30, 1 << 31, 2000, dtype=np.uint64)
    hi = lo + np.uint64(255)
    ks = np.sort(keys)
    idx = np.searchsorted(ks, lo)
    empty = ~((idx < len(ks)) & (ks[np.minimum(idx, len(ks) - 1)] <= hi))

    def fpr(store):
        fence, filt = store.probe_runs(lo[empty], hi[empty])
        return float((fence & filt).any(axis=1).mean())

    assert fpr(adaptive.store) < fpr(static.store)


def test_adaptive_deletable_churn_equals_the_reference():
    """A small adaptive, deletable churn at d = 24: puts, 40% deletes of
    the oldest live key, two batches of live scans; equal stats, runs,
    events and reads."""
    def run(store):
        rng = np.random.default_rng(0xDE1E7E)
        model, scans = {}, []
        for i in range(2000):
            if model and rng.random() < 0.4:
                k = int(next(iter(model)))
                store.delete(k)
                del model[k]
            else:
                k = int(rng.integers(0, 1 << 24))
                store.put(k, i)
                model[k] = i
            if i % 1000 == 300:
                lo = rng.integers(0, (1 << 24) - 64, 64, dtype=np.uint64)
                scans.append(store.scan_many(lo, lo + np.uint64(63)))
        store.flush()
        live = np.fromiter(model, np.uint64, len(model))
        return scans, store.get_many(live), [model[int(k)] for k in live]

    cfg = dict(d=24, memtable_limit=128, level0_runs=2, fanout=4,
               bits_per_key=14.0, mutability="deletable", tuning="adaptive")
    ref = _fast_builds(RStore(RConfig(**cfg), _warn=False))
    port = Store(StoreConfig(**cfg), device="cpu")
    want = run(ref)
    got = run(port)
    assert got == want and got[1] == got[2]
    st = port.stats.as_dict()
    assert st == ref.stats.as_dict()
    assert st["retunes"] >= 1 and st["purge_rebuilds"] > 0
    assert _runs(port) == _runs(ref)
    assert port._tuner.events == ref._tuner.events


def test_adaptive_checkpoint_opens_in_the_other_package(tmp_path):
    """A durable adaptive store's checkpoint carries its workload model:
    each package opens the other's directory and resumes with the same
    sample, retune count and reads."""
    keys, slo, shi = _skewed_ops(0xBEEF, n_keys=4000, n_scans=128)
    cfg = dict(d=32, memtable_limit=400, level0_runs=3, fanout=4,
               bits_per_key=14.0, tuning="adaptive", durability="wal")
    ref = _fast_builds(RStore(RConfig(wal_dir=str(tmp_path / "r"), **cfg),
                              _warn=False))
    port = Store(StoreConfig(wal_dir=str(tmp_path / "p"), **cfg),
                 device="cpu")
    want = _drive(ref, keys, slo, shi)
    assert _drive(port, keys, slo, shi) == want
    assert port.stats.retunes == ref.stats.retunes >= 1
    ref.checkpoint()
    port.checkpoint()
    snap_p, snap_r = port.snapshot(), ref.snapshot()
    assert snap_p["workload"] == snap_r["workload"]
    ref.close()
    port.close()
    from_ref = Store.open(str(tmp_path / "r"), device="cpu")
    from_port = RStore.open(str(tmp_path / "p"))
    for a, b in ((from_ref, ref), (from_port, port)):
        assert a._tuner is not None
        assert a._tuner.to_dict() == b._tuner.to_dict()
        assert a.stats.retunes == b.stats.retunes
    qs = np.unique(keys)[:400]
    assert from_ref.get_many(qs) == from_port.get_many(qs) == want[1][:400]
    assert from_ref.scan_many(slo, shi) == port.scan_many(slo, shi)
    assert _runs(from_ref) == _runs(from_port)
    from_ref.close()
    from_port.close()
