"""The port's durable LSM store (``durability="wal"``) on the CPU against
``repro``'s: byte-identical write-ahead logs for one op stream, snapshots
equal field by field, checkpoint directories that open in the other
package and scan identically, recovery after a crash at every fault seam,
torn WAL tails, quarantine of a corrupted filter block, scrubs, and the
older run-snapshot schemas.

The reference's durable stores are small (d = 16, memtable 32) and share
one op stream, so its JAX compiles are paid a few times per module.  The
1e5-op crash soak runs under ``-m slow``."""
import copy
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro.store import Wal as RWal
from repro_torch.store import (WAL_FILENAME, FaultPlan, InjectedCrash, Run,
                               Store, StoreConfig, Wal, fault_seed_from_env)
from repro_torch.store.faults import flip_filter_bits, truncate_tail
from repro_torch.store.integrity import read_manifest, write_manifest

SEAMS = ["wal.append", "flush.after_run", "compact.before_swap",
         "snapshot.before_rename", "manifest.before_rename"]
_CFG = dict(d=16, memtable_limit=32, level0_runs=2, fanout=4,
            use_insert_kernels=True)


def _ops(seed: int = 0xD0A, n: int = 300):
    """Puts (int and str values), single deletes and ``delete_many``
    sweeps (numpy codes, as the façade passes them) over 16-bit keys."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.random()
        if r < 0.7:
            v = int(rng.integers(1 << 30)) if i % 3 else f"v{i}"
            ops.append(("put", int(rng.integers(0, 1 << 16)), v))
        elif r < 0.9:
            ops.append(("del", int(rng.integers(0, 1 << 16))))
        else:
            ops.append(("delm", rng.integers(0, 1 << 16, 5, dtype=np.uint64)))
    return ops


def _apply(store, ops) -> None:
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2])
        elif op[0] == "del":
            store.delete(op[1])
        else:
            store.delete_many(op[1])


def _probe_set(store):
    """A fixed read set: every 5th key of every run and the memtable, and
    64 scans over the domain."""
    keys = sorted({int(k) for r in store.live_runs() for k in r.keys[::5]}
                  | {int(k) for k, _ in store.mem.items()})
    lo = np.arange(0, 1 << 16, 1 << 10, dtype=np.uint64)
    return np.asarray(keys, np.uint64), lo, lo + np.uint64(700)


def _reads(store, keys, lo, hi):
    return store.get_many(keys), store.scan_many(lo, hi)


def _pair(tmp_path, **kw):
    cfg = dict(_CFG, **kw)
    ref = RStore(RConfig(durability="wal", wal_dir=str(tmp_path / "ref"),
                         **cfg), _warn=False)
    port = Store(StoreConfig(durability="wal", wal_dir=str(tmp_path / "port"),
                             **cfg), device="cpu")
    return ref, port


def test_wal_files_are_byte_identical(tmp_path):
    ref, port = _pair(tmp_path)
    ops = _ops()
    _apply(ref, ops)
    _apply(port, ops)
    ref.close()
    port.close()
    want = (tmp_path / "ref" / WAL_FILENAME).read_bytes()
    assert (tmp_path / "port" / WAL_FILENAME).read_bytes() == want
    assert port.stats.wal_appends == ref.stats.wal_appends == len(ops)
    # each package replays the other's log
    assert Wal(str(tmp_path / "ref" / WAL_FILENAME)).records() == \
        RWal(str(tmp_path / "port" / WAL_FILENAME)).records()


def _assert_enc_equal(a, b, path="snap"):
    """Deep equality of two snapshot values (numpy arrays by content)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_enc_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_enc_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_snapshots_equal_field_by_field(tmp_path):
    ref, port = _pair(tmp_path, mutability="deletable")
    _apply(ref, _ops())
    _apply(port, _ops())
    blobs = [pickle.dumps(s.snapshot(), protocol=pickle.HIGHEST_PROTOCOL)
             for s in (ref, port)]
    ref.close()
    port.close()
    assert b"torch" not in blobs[1]          # host data only
    want, got = (pickle.loads(b) for b in blobs)
    for snap in (want, got):
        snap["config"].pop("wal_dir")
    _assert_enc_equal(got, want)
    assert sum(len(lvl) for lvl in got["levels"]) >= 2


def test_checkpoints_open_across_packages(tmp_path):
    """A ``repro`` checkpoint directory (snapshot + manifest + a WAL tail)
    opens in the port and reads identically, and the other way round."""
    ref, port = _pair(tmp_path)
    ops = _ops()
    for st in (ref, port):
        _apply(st, ops[:200])
        st.checkpoint()
        _apply(st, ops[200:])                # the tail lives in the WAL
        st.close()
    from_ref = Store.open(str(tmp_path / "ref"), device="cpu")
    from_port = RStore.open(str(tmp_path / "port"))
    keys, lo, hi = _probe_set(from_ref)
    want = _reads(ref, keys, lo, hi)
    assert _reads(from_ref, keys, lo, hi) == want
    assert _reads(from_port, keys, lo, hi) == want
    assert _reads(port, keys, lo, hi) == want
    assert from_ref.stats.wal_replayed == from_port.stats.wal_replayed == 100
    assert from_ref.stats.durable_snapshot() == \
        from_port.stats.durable_snapshot() == port.stats.durable_snapshot()
    for a, b in zip(from_ref.live_runs(), port.live_runs()):
        assert a.checksums() == b.checksums()
    from_ref.close()
    from_port.close()


def _fuzz_round(tmpdir, seed, n_ops, seam, countdown) -> bool:
    """The reference's crash round on the port: interleave ops, crash at
    ``seam``, reopen, and check every acknowledged write."""
    rng = np.random.default_rng(seed)
    cfg = StoreConfig(durability="wal", wal_dir=str(tmpdir), d=16,
                      memtable_limit=24, level0_runs=2)
    store = Store.open(str(tmpdir), cfg, device="cpu",
                       faults=FaultPlan(seed=seed, crashes={seam: countdown}))
    model, crashed, inflight = {}, False, None
    for _ in range(n_ops):
        kind = rng.choice(["put", "put", "put", "del", "delm", "ckpt"])
        try:
            if kind == "put":
                k, v = int(rng.integers(0, 1 << 16)), int(rng.integers(1e9))
                inflight = {k: v}
                store.put(k, v)
                model[k] = v
            elif kind == "del":
                k = int(rng.integers(0, 1 << 16))
                inflight = {k: None}
                store.delete(k)
                model.pop(k, None)
            elif kind == "delm":
                ks = [int(x) for x in rng.integers(0, 1 << 16, 5)]
                inflight = {k: None for k in ks}
                store.delete_many(ks)
                for k in ks:
                    model.pop(k, None)
            else:
                inflight = {}
                store.checkpoint()
            inflight = None
        except InjectedCrash:
            crashed = True
            break
    store.close()
    wal_path = os.path.join(str(tmpdir), WAL_FILENAME)
    if crashed and os.path.exists(wal_path) and rng.random() < 0.5:
        with open(wal_path, "ab") as f:     # a torn in-flight frame
            f.write(b"\x40\x00\x00\x00torn-in-flight-frame")
    rec = Store.open(str(tmpdir), device="cpu")
    either = inflight if (crashed and inflight) else {}
    for k, v in model.items():
        got = rec.get(k)
        assert got in ((v, either[k]) if k in either else (v,)), (seam, k)
    live = sorted(k for k in model if k not in either)
    if live:
        pick = live[:: max(1, len(live) // 32)]
        lo = np.asarray(pick, np.uint64)
        for k, rows in zip(pick, rec.scan_many(lo, lo)):
            assert rows == [(k, model[k])], (seam, k)
    rec.scrub(sample_keys=16)
    rec.close()
    return crashed


@pytest.mark.parametrize("seam", SEAMS)
def test_crash_at_each_seam_recovers_every_acked_write(tmp_path, seam):
    seed = fault_seed_from_env(default=0xFA17)
    fired = False
    for countdown in (1, 3):
        sub = tmp_path / f"c{countdown}"
        sub.mkdir()
        fired |= _fuzz_round(sub, seed + countdown, 160, seam, countdown)
    assert fired, f"seam {seam} never fired"


@pytest.mark.slow
def test_crash_recovery_soak_1e5(tmp_path):
    """The reference's 1e5-op soak on the port: repeated crash/reopen
    cycles against one durable directory, cycling through every seam."""
    seed = fault_seed_from_env(default=0xFA17)
    rng = np.random.default_rng(seed)
    cfg = StoreConfig(durability="wal", wal_dir=str(tmp_path), d=16,
                      memtable_limit=64, level0_runs=2)
    model, ops_done, crashes, seam_i = {}, 0, 0, 0
    store = Store.open(str(tmp_path), cfg, device="cpu")
    while ops_done < 100_000:
        if store.faults is None or not any(store.faults.armed(s)
                                           for s in SEAMS):
            store.faults = FaultPlan(seed=int(rng.integers(1 << 30)),
                                     crashes={SEAMS[seam_i % len(SEAMS)]:
                                              int(rng.integers(1, 40))})
            seam_i += 1
        kind = rng.choice(["put", "put", "put", "del", "ckpt"],
                          p=[0.3, 0.3, 0.3, 0.09, 0.01])
        inflight = None
        try:
            if kind == "put":
                k, v = int(rng.integers(0, 1 << 16)), int(rng.integers(1e9))
                inflight = k
                store.put(k, v)
                model[k] = v
            elif kind == "del":
                k = int(rng.integers(0, 1 << 16))
                inflight = k
                store.delete(k)
                model.pop(k, None)
            else:
                store.checkpoint()
            ops_done += 1
        except InjectedCrash:
            crashes += 1
            store.close()
            store = Store.open(str(tmp_path), device="cpu")
            if inflight is not None:         # the crashed op: either state
                got = store.get(inflight)
                if got is None:
                    model.pop(inflight, None)
                else:
                    model[inflight] = got
    store.close()
    rec = Store.open(str(tmp_path), device="cpu")
    keys = np.fromiter(model, np.uint64, len(model))
    assert rec.get_many(keys) == [model[int(k)] for k in keys]
    assert crashes > 10


def test_truncated_tail_heals_to_a_prefix(tmp_path):
    path = str(tmp_path / WAL_FILENAME)
    w = Wal(path).open_for_append()
    recs = [("put", i, f"v{i}") for i in range(40)] + [("delm", [1, 2], None)]
    for op, k, v in recs:
        w.append(op, k, v)
    w.close()
    plan = FaultPlan(seed=3)
    cut = truncate_tail(path, plan.rng, max_bytes=20)
    assert 1 <= cut <= 20
    got = Wal(path).records()
    assert got == recs[:len(got)] and len(got) == len(recs) - 1
    assert RWal(path).records() == got       # the reference reads the same
    w = Wal(path).open_for_append()          # heal, then append after it
    assert w.torn_bytes > 0
    w.append("del", 7)
    w.close()
    assert Wal(path).records() == got + [("del", 7, None)]


def _filtered_store(seed: int, scan_backend: str = "xla"):
    st = Store(StoreConfig(scan_backend=scan_backend, **_CFG), device="cpu")
    rng = np.random.default_rng(seed)
    for k in rng.choice(1 << 16, 600, replace=False):
        st.put(int(k), int(k) * 3)
    for k in rng.choice(1 << 16, 60, replace=False):
        st.delete(int(k))
    st.flush()
    return st


@pytest.mark.parametrize("scan_backend", ["kernel", "xla"])
def test_flipped_filter_bits_quarantine_with_exact_scans(scan_backend):
    st = _filtered_store(5, scan_backend)
    snap = st.snapshot()
    lvl = next(i for i, lv in enumerate(snap["levels"]) if lv)
    bad = copy.deepcopy(snap)
    bad["levels"][lvl][0] = flip_filter_bits(snap["levels"][lvl][0],
                                             FaultPlan(seed=9).rng, nbits=3)
    ctrl = Store.restore(copy.deepcopy(snap), device="cpu")
    port = Store.restore(copy.deepcopy(bad), device="cpu")
    ref = RStore.restore(copy.deepcopy(bad))
    assert len(port.quarantined_runs()) == len(ref.quarantined_runs()) == 1
    assert port.quarantined_runs()[0] is port.levels[lvl][0]
    keys, lo, hi = _probe_set(ctrl)
    want = _reads(ctrl, keys, lo, hi)
    assert _reads(port, keys, lo, hi) == want == _reads(ref, keys, lo, hi)
    assert port.stats.degraded_probes == ref.stats.degraded_probes > 0
    # the device plane masks the row too (the store-scan kernel's plain
    # version here), and the scrub reports it
    clo = torch.from_numpy(lo.astype(np.int64))
    fence, touch = port.scan_probe_device(clo, clo + 700)
    q = [i for i, r in enumerate(port.live_runs()) if r.quarantined][0]
    assert bool((touch[:, q] == fence[:, q]).all())
    assert port.scrub()["quarantined"] == 1


def test_scrub_reports_equal_the_references():
    """A bit flipped in a live run's filter block (in memory): both
    packages' scrubs quarantine that run and report the same counts."""
    port = _filtered_store(11)
    ref = RStore.restore(port.snapshot())
    assert port.scrub(sample_keys=8) == ref.scrub(sample_keys=8)
    run = port.live_runs()[0]
    lanes = run.state_numpy()
    lanes[3] ^= np.uint32(1 << 7)
    run.state = torch.from_numpy(lanes.view(np.int32).copy())
    rrun = ref.live_runs()[0]
    rrun.state = rrun.state.at[3].set(lanes[3])
    got, want = port.scrub(sample_keys=8, seed=2), ref.scrub(sample_keys=8,
                                                            seed=2)
    assert got == want and got["newly_quarantined"] == 1
    assert run.quarantined and port.quarantined_runs() == [run]


@pytest.mark.parametrize("schema", ["bloomrf-run/v1", "bloomrf-run/v2"])
def test_older_run_schemas_unpack(schema):
    st = _filtered_store(7)
    enc = dict(st.live_runs()[0].pack(), schema=schema)
    enc["crc"] = {"keys": 0}                 # ignored before v3
    got = Run.unpack(enc, device="cpu")
    want = st.live_runs()[0]
    np.testing.assert_array_equal(got.keys, want.keys)
    np.testing.assert_array_equal(got.state_numpy(), want.state_numpy())
    assert not got.quarantined and got.vals == want.vals
    rgot = repro.store.Run.unpack(copy.deepcopy(enc))
    np.testing.assert_array_equal(np.asarray(rgot.state), got.state_numpy())
    for junk in (None, [1], {"schema": "bloomrf-run/v3"},
                 dict(enc, schema="bloomrf-run/v9")):
        with pytest.raises(ValueError):
            Run.unpack(junk, device="cpu")


def test_failed_device_copy_raises_not_quarantines(monkeypatch):
    """Only an undecodable or mismatched filter block quarantines; a copy
    to the device that fails raises out of ``unpack`` and ``restore``."""
    st = _filtered_store(7)
    snap = st.snapshot()
    enc = st.live_runs()[0].pack()

    def fail(self, *a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(torch.Tensor, "to", fail)
    with pytest.raises(RuntimeError, match="out of memory"):
        Run.unpack(copy.deepcopy(enc), device="cpu")
    with pytest.raises(RuntimeError, match="out of memory"):
        Store.restore(copy.deepcopy(snap), device="cpu")


def test_corrupt_snapshots_raise_or_degrade_as_the_reference():
    st = _filtered_store(13)
    snap = st.snapshot()
    run = next(e for lv in snap["levels"] for e in lv)
    cases = [dict(snap, schema="bloomrf-store/v99"),
             dict(snap, config={"filter_backend": "quantum"}),
             dict(snap, levels={"not": "a list"}),
             dict(snap, workload={"d": 16})]
    for field, value in (("n", run["n"] + 1), ("layout", {"bogus": True}),
                         ("vals", ["x"] * run["n"])):
        bad = copy.deepcopy(snap)
        next(e for lv in bad["levels"] for e in lv)[field] = value
        cases.append(bad)
    for bad in cases:
        with pytest.raises(ValueError):
            Store.restore(copy.deepcopy(bad), device="cpu")
        with pytest.raises(ValueError):
            RStore.restore(copy.deepcopy(bad))


def test_durable_directory_contract(tmp_path):
    """A fresh durable store refuses a directory holding state; a corrupt
    manifest is refused with an actionable error; a checkpoint needs a
    WAL; a snapshot without a flush warns only when no WAL holds the
    memtable."""
    cfg = StoreConfig(durability="wal", wal_dir=str(tmp_path), **_CFG)
    st = Store(cfg, device="cpu")
    st.put(1, "a")
    st.checkpoint()
    st.put(2, "b")
    st.snapshot(flush_first=False)           # the WAL covers the memtable
    st.close()
    with pytest.raises(ValueError, match="Store.open"):
        Store(cfg, device="cpu")
    rec = Store.open(str(tmp_path), device="cpu")
    assert rec.get(1) == "a" and rec.get(2) == "b"
    assert read_manifest(str(tmp_path))["seq"] == 1
    rec.close()
    write_manifest(str(tmp_path), {"snapshot": "x", "crc32": 0, "seq": 1})
    (tmp_path / "MANIFEST.json").write_text('{"payload": {}, "crc": 1}')
    with pytest.raises(ValueError, match="manifest"):
        Store.open(str(tmp_path), device="cpu")
    plain = Store(StoreConfig(**_CFG), device="cpu")
    plain.put(3, "c")
    with pytest.raises(ValueError, match="durability"):
        plain.checkpoint()
    with pytest.warns(RuntimeWarning, match="unflushed"):
        plain.snapshot(flush_first=False)


def test_facade_passes_deletable_wal_specs_through(tmp_path):
    """``open_filter`` of a deletable, durable store spec in both packages:
    the same WAL bytes and scans; the port's ``checkpoint``/``scrub``/
    ``close`` reach the store, and ``Store.open`` recovers it."""
    kw = dict(dtype="u16", placement="store", memtable_limit=32,
              level0_runs=2, fanout=4, mutability="deletable",
              durability="wal", backend="xla")
    ref = repro.open_filter(repro.FilterSpec(wal_dir=str(tmp_path / "r"),
                                             **kw))
    port = repro_torch.open_filter(repro_torch.FilterSpec(
        wal_dir=str(tmp_path / "p"), **kw), device="cpu")
    assert {**dataclasses.asdict(port.store.cfg), "wal_dir": None} == \
        {**dataclasses.asdict(ref.store.cfg), "wal_dir": None}
    keys = np.random.default_rng(2).choice(1 << 16, 150, replace=False)
    for h in (ref, port):
        for k in keys:
            h.put(int(k), int(k))
        h.delete_many(keys[:45])
    assert (tmp_path / "p" / WAL_FILENAME).read_bytes() == \
        (tmp_path / "r" / WAL_FILENAME).read_bytes()
    port.checkpoint()
    assert port.scrub()["quarantined"] == 0
    lo = np.arange(0, 1 << 16, 1 << 11)
    want = ref.scan_many(lo, lo + 1500)
    assert port.scan_many(lo, lo + 1500) == want
    port.close()
    rec = Store.open(str(tmp_path / "p"), device="cpu")
    assert rec.scan_many(lo.astype(np.uint64), (lo + 1500).astype(np.uint64)) \
        == want
    assert rec.cfg.mutability == "deletable"
    rec.close()
    ref.close()


def test_quarantined_run_never_enters_an_or_merge():
    """ROADMAP C.6: a run restored quarantined (flipped filter bits) and
    then compacted with same-class runs.  The reference ORs its corrupt
    state into a trusted run, so gets miss stored keys; the port rebuilds
    that merge from the keys and reads every key."""
    def drive(make_store, restore):
        st = make_store()
        keys = np.random.default_rng(13).choice(1 << 24, 30, replace=False)
        for k in keys[:10]:
            st.put(int(k), int(k))
        st.flush()
        snap = st.snapshot()
        snap["levels"][0][0] = flip_filter_bits(
            snap["levels"][0][0], FaultPlan(seed=13).rng, nbits=8)
        q = restore(snap)
        assert len(q.quarantined_runs()) == 1
        for j in (10, 20):                   # two flushes: a level-0 merge
            for k in keys[j:j + 10]:
                q.put(int(k), int(k))
            q.flush()
        assert q.stats.compactions == 1 and not q.quarantined_runs()
        return q.get_many(keys), [int(k) for k in keys], q.stats

    cfg = dict(d=24, memtable_limit=64, level0_runs=2, fanout=4,
               scan_backend="xla")
    got, want, stats = drive(lambda: Store(StoreConfig(**cfg), device="cpu"),
                             lambda s: Store.restore(s, device="cpu"))
    assert got == want and stats.rebuild_merges == 1
    rgot, _, rstats = drive(lambda: RStore(RConfig(**cfg), _warn=False),
                            RStore.restore)
    assert rstats.or_merges == 1 and sum(a is None for a in rgot) > 0
