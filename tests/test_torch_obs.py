"""The port's observability plane (``repro_torch.obs``) on the CPU against
``repro.obs``: the registry's semantics and ``export_snapshot`` for one op
stream, the ``FprSampler`` for one seed, the span records of the façade,
store, WAL and kernel-dispatch paths (names, attributes, schema), the
façade's ``observed_fpr``, and verdicts and states unchanged with obs on.

Both packages keep a process-global registry and ``BLOOMRF_OBS`` flag, so
a fixture gives every test fresh registries with obs off and closes both
trace sinks."""
import dataclasses
import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import obs as robs
from repro.core import FilterLayout as RLayout
from repro.kernels import FilterOps as RFilterOps
from repro.obs import metrics as rmetrics
from repro.obs import trace as rtrace
from repro_torch import obs
from repro_torch.core import BloomRF, basic_layout
from repro_torch.kernels import FilterOps
from repro_torch.obs import metrics, trace
from repro_torch.store import Store, StoreConfig


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for m in (metrics, rmetrics):
        monkeypatch.setattr(m, "_REGISTRY", m.MetricsRegistry())
        monkeypatch.setattr(m, "_ENABLED", False)
    yield
    trace.set_trace_sink(None)
    rtrace.set_trace_sink(None)


def _both(fn):
    """Run ``fn(metrics_module, scalar)`` on both packages' registries, the
    device scalar a jax array for ``repro`` and a tensor for the port;
    returns both ``export_snapshot()`` documents."""
    fn(rmetrics, lambda v: jnp.asarray(v))
    fn(metrics, lambda v: torch.tensor(v))
    return robs.export_snapshot({"x/extra": 1.5}), \
        obs.export_snapshot({"x/extra": 1.5})


def test_registry_stream_exports_as_the_reference():
    def stream(m, dev):
        reg = m.registry()
        c = reg.counter("unit/c")
        c.add(3)
        c.add(dev(4))                    # device scalars: stashed
        c.add(dev(5))
        c.add(0.5)
        reg.counter("unit/n").add(dev(2))
        g = reg.gauge("unit/g")
        g.set(2.5)
        reg.gauge("unit/dev").set(dev(7.0))
        h = reg.histogram("unit/h", buckets=(1.0, 10.0, 100.0))
        h.observe(5.0)
        h.observe_many(np.asarray([0.5, 50.0, 50.0, 1e6]))
        reg.histogram("unit/lat").observe(1234.0)
        assert reg.register_family("fam", lambda: {"a": 1, "b": 2.5}) == "fam"
        assert reg.register_family("fam", lambda: {"a": 9}) == "fam#2"
        reg.register_family("gone", lambda: None)   # dead owner: pruned
        for other in (reg.gauge, reg.histogram):
            with pytest.raises(TypeError):
                other("unit/c")
    want, got = _both(stream)
    assert got == want
    assert got["metrics"]["unit/c"] == 12.5
    assert isinstance(got["metrics"]["unit/n"], int)
    assert got["metrics"]["unit/h"] == {"count": 5, "mean": want["metrics"][
        "unit/h"]["mean"], "p50": 100.0, "p99": 100.0}
    # a reset zeroes metrics and keeps families, in both
    rmetrics.registry().reset()
    metrics.registry().reset()
    assert metrics.registry().snapshot() == rmetrics.registry().snapshot()
    assert metrics.registry().snapshot()["fam/a"] == 1


def test_counter_add_of_a_tensor_stashes_until_the_snapshot():
    c = metrics.registry().counter("unit/t")
    t = torch.tensor(3, dtype=torch.int64)
    c.add(t)
    c.add(t)
    assert c._host == 0.0 and len(c._pending) == 2   # nothing settled yet
    assert metrics.registry().snapshot()["unit/t"] == 6
    assert c._pending == []


def test_fpr_sampler_outputs_equal_the_references():
    """One seed, one stream of inserts, ground-truth marks, ranges and
    re-probes: the same reservoirs, workload sample, histogram and FPRs."""
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 1 << 20, 3000, dtype=np.uint64)
    hi = lo + rng.integers(0, 1 << 12, 3000, dtype=np.uint64)
    ins = rng.integers(0, 1 << 20, 70_000, dtype=np.uint64)
    outs = []
    for pkg in (robs, obs):
        pkg.enable()
        s = pkg.FprSampler(20, n_keys=256, n_ranges=256, range_len=64,
                           seed=11, reservoir_cap=64)
        s.observe_insert(ins[:40_000])
        s.observe_insert(ins[40_000:])   # crosses the lazy-settle size
        s.observe_ranges(lo, hi)
        probe = (lambda k: (k & np.uint64(3)) == 0)
        a = s.sample(point_probe=probe,
                     range_probe=lambda a, b: (b - a) > np.uint64(62))
        s.mark_present(ins[:500])
        b = s.sample(point_probe=probe)
        outs.append((a, b, s.workload_sample(), s.workload_seen,
                     s.range_log2_counts.tolist(), s.live_points().tolist(),
                     [x.tolist() for x in s.live_ranges()],
                     pkg.export_snapshot()))
        pkg.disable()
    assert outs[1] == outs[0]
    assert outs[0][0]["point_candidates"] > 0 and "range_fpr" in outs[0][0]


def _records(path) -> list:
    recs = [json.loads(ln) for ln in open(path)]
    for r in recs:
        assert r["schema"] == "bloomrf-trace/v1" and r["dur_us"] >= 0.0
    return [(r["span"], r.get("attrs")) for r in recs]


def _store_spec(tmp, tag):
    return dict(dtype="u32", placement="store", memtable_limit=64,
                level0_runs=2, fanout=4, backend="xla",
                mutability="deletable", durability="wal",
                wal_dir=str(tmp / tag))


def test_span_records_match_the_references(tmp_path):
    """The façade (single filter and store), the store's flush, compaction,
    get, scan, checkpoint and WAL paths emit the same spans, with the same
    names and attributes, in the same order, in both packages."""
    rng = np.random.default_rng(8)
    keys = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 300, dtype=np.uint64)
    hi = lo + np.uint64(1 << 20)
    got = {}
    for name, pkg, kw in (("ref", repro, {}), ("port", repro_torch,
                                               {"device": "cpu"})):
        o = robs if pkg is repro else obs
        o.enable()
        sink = tmp_path / f"{name}.jsonl"
        o.set_trace_sink(str(sink))
        f = pkg.open_filter(pkg.FilterSpec(dtype="u32", n=1000,
                                           backend="xla"), **kw)
        f.insert(keys)
        f.point(keys[:100])
        f.range(lo, hi)
        st = pkg.open_filter(pkg.FilterSpec(**_store_spec(tmp_path, name)),
                             **kw)
        for i, k in enumerate(keys[:200]):
            st.put(int(k), i)
        st.delete_many(keys[:40])
        st.get(int(keys[50]))
        st.get_many(keys[:20])
        st.scan_many(lo[:50], hi[:50])
        st.checkpoint()
        st.close()
        o.set_trace_sink(None)
        got[name] = (_records(sink), o.export_snapshot()["metrics"])
        o.disable()
    (want, wsnap), (have, hsnap) = got["ref"], got["port"]
    assert have == want
    names = {n for n, _ in want}
    assert {"facade/insert", "facade/range", "facade/put", "facade/scan",
            "store/flush", "store/compact", "compaction/merge_filters",
            "store/checkpoint", "wal/append", "store/get"} <= names
    assert {k: v for k, v in hsnap.items()
            if not k.startswith("obs/latency")} == \
        {k: v for k, v in wsnap.items() if not k.startswith("obs/latency")}
    assert hsnap["store/puts"] == 200 and hsnap["wal/appends"] == 201
    assert {k: v["count"] for k, v in hsnap.items()
            if k.startswith("obs/latency")} == \
        {k: v["count"] for k, v in wsnap.items()
         if k.startswith("obs/latency")}


def test_kernel_dispatch_counts_and_spans_match(tmp_path):
    """``FilterOps`` on a resident layout: the same ``kernel/dispatch/*``
    counts and ``kernel/*`` spans as the reference's interpret-mode
    kernels, the same state and verdicts, and the same with obs off."""
    lay = basic_layout(32, 2000, 16.0, delta=7)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    hi = np.minimum(lo + np.uint64(1 << 16), np.uint64((1 << 32) - 1))
    rops = RFilterOps(RLayout(**dataclasses.asdict(lay)), interpret=True,
                      _warn=False)
    robs.enable()
    rtrace.set_trace_sink(str(tmp_path / "r.jsonl"))
    rs = rops.insert(rops.init_state(), jnp.asarray(keys, jnp.uint32))
    want = (np.asarray(rs), np.asarray(rops.point(rs, jnp.asarray(
        keys[:256], jnp.uint32))), np.asarray(rops.range(
            rs, jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32))))
    rtrace.set_trace_sink(None)

    def port_run():
        ops = FilterOps(lay)
        t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
        s = ops.insert(BloomRF(lay, device="cpu").init_state(), t(keys))
        return (s.numpy().view(np.uint32), ops.point(s, t(keys[:256])).numpy(),
                ops.range(s, t(lo), t(hi)).numpy())

    off = port_run()
    obs.enable()
    trace.set_trace_sink(str(tmp_path / "p.jsonl"))
    on = port_run()
    trace.set_trace_sink(None)
    for a, b, c in zip(off, on, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert _records(tmp_path / "p.jsonl") == _records(tmp_path / "r.jsonl")
    psnap, rsnap = obs.export_snapshot(), robs.export_snapshot()
    assert psnap["metrics"]["kernel/dispatch/resident"] == \
        rsnap["metrics"]["kernel/dispatch/resident"] == 3


def test_facade_unchanged_with_obs_on_and_observed_fpr_equal():
    """Verdicts and states of the single filter and the store with obs on
    equal those with it off and the reference's; ``observed_fpr`` of both
    handles equals the reference's, and publishes the same gauges."""
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 1 << 32, 2000, dtype=np.uint64)
    lo = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    hi = lo + rng.integers(0, 1 << 16, 1000, dtype=np.uint64)
    skw = dict(dtype="u32", placement="store", memtable_limit=256,
               level0_runs=4, fanout=4, backend="xla")

    def drive(pkg, on, **kw):
        o = robs if pkg is repro else obs
        (o.enable if on else o.disable)()
        out = {}
        for backend in ("xla", "resident") if pkg is repro_torch else ("xla",):
            f = pkg.open_filter(pkg.FilterSpec(dtype="u32", n=2000,
                                               backend=backend), **kw)
            f.insert(keys)
            out[backend] = (np.asarray(f.state_numpy() if pkg is repro_torch
                                       else f.state),
                            f.point(keys[::7]), f.range(lo, hi))
        st = pkg.open_filter(pkg.FilterSpec(**skw), **kw)
        for i, k in enumerate(keys[:600]):
            st.put(int(k), i)
        st.delete_many(keys[:120])
        out["store"] = (st.scan_many(lo[:200], hi[:200]),
                        st.get_many(keys[::11]), st.stats.as_dict())
        fprs = (f.observed_fpr(), st.observed_fpr()) if on else None
        gauges = {k: v for k, v in o.export_snapshot()["metrics"].items()
                  if k.startswith("obs/fpr")}
        o.disable()
        return out, fprs, gauges

    ref, rfpr, rg = drive(repro, True)
    off, _, _ = drive(repro_torch, False, device="cpu")
    on, pfpr, pg = drive(repro_torch, True, device="cpu")
    for a, b in ((off, on), (on, {**ref, "resident": ref["xla"]})):
        for k in a:
            for x, y in zip(a[k], b[k]):
                if isinstance(x, np.ndarray):
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y
    assert pfpr == rfpr and pg == rg
    assert "point_fpr" in pfpr[0] and "range_fpr_per_run" in pfpr[1]


def test_store_family_and_durable_stats(tmp_path):
    """A store registers its stats as a family when obs is on, drops out
    of the snapshot once collected, and the scan-plane batch odometer
    counts device-plane calls without touching the result."""
    obs.enable()
    st = Store(StoreConfig(memtable_limit=100), device="cpu")
    for k in range(250):
        st.put(k * 977, k)
    lo = torch.tensor([0, 5000])
    st.scan_probe_device(lo, lo + 10_000)
    snap = obs.export_snapshot()["metrics"]
    assert snap["store/puts"] == 250 and snap["store/flushes"] == 2
    assert snap["store/scan_probe_batches"] == 1
    assert st.register_obs() == "store#2"
    del st
    gc.collect()
    left = metrics.registry().snapshot()
    assert "store/puts" not in left and left["store/scan_probe_batches"] == 1
    assert not any(k.startswith("store#2/") for k in left)
