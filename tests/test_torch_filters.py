"""The port's ``filters/`` package and the stores built on it, on the CPU
against ``repro``, with exact equality:

* the six host baselines (Bloom, prefix Bloom, Rosetta, SuRF-lite, cuckoo,
  fence pointers) built from the same seeded keys hold equal arrays and
  answer equal point and range verdicts;
* ``BloomRFAdapter`` (the port's over its façade, ``backend="auto"``) holds
  the reference adapter's state at d = 32 and d = 64;
* one op stream through a store of each host ``filter_backend`` gives equal
  scans, gets and ``StoreStats``, and each package restores the other's
  snapshot (baselines do not snapshot; both rebuild them from the keys);
* the ``str`` (per-code buckets) and ``multiattr`` (pair bounds) typed
  stores answer as the reference façade does, and a durable one's
  checkpoint opens in either package.

Inputs come from local numpy generators, never from the shared ``rng``
fixture of conftest.py."""
import dataclasses
import functools
import pickle
import random

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro import filters as RF
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro_torch import filters as PF
from repro_torch.store import WAL_FILENAME, Store, StoreConfig

from conftest import brute_force_range_truth
from test_torch_tune import _fast_builds, _runs


def _same(a, b, path="") -> None:
    """Deep equality of two filters' attributes (arrays by value)."""
    if hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        _same(vars(a), vars(b), path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@functools.lru_cache(maxsize=None)
def _data(bits: int = 63, n: int = 20_000):
    rng = np.random.default_rng(0xF117)
    keys = rng.integers(0, 1 << bits, n, dtype=np.uint64)
    lo = np.concatenate([keys[:500] - np.uint64(300),
                         rng.integers(0, 1 << bits, 1500, dtype=np.uint64)])
    hi = lo + rng.integers(0, 1 << 10, len(lo), dtype=np.uint64)
    pq = np.concatenate([keys[:500],
                         rng.integers(0, 1 << bits, 1500, dtype=np.uint64)])
    return keys, lo, hi, pq


BASELINES = {
    "bloom": (lambda F: F.BloomFilter(12), False),
    "prefix_bloom": (lambda F: F.PrefixBloomFilter(16, prefix_level=10), True),
    "rosetta": (lambda F: F.Rosetta(18, max_range_log2=10), True),
    "surf": (lambda F: F.SuRFLite.for_budget(16), True),
    "surf_hash": (lambda F: F.SuRFLite(suffix_bits=8, mode="hash"), True),
    "cuckoo": (lambda F: F.CuckooFilter(12), False),
    "minmax": (lambda F: F.FencePointers(16), True),
}


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_baseline_equals_the_reference(name):
    make, ranges = BASELINES[name]
    keys, lo, hi, pq = _data()
    if name == "cuckoo":            # a Python loop per key
        keys = keys[:4000]
    ref, port = make(RF), make(PF)
    ref.build(keys)
    port.build(keys)
    _same(port, ref)
    assert port.size_bits() == ref.size_bits()
    pts = port.point(pq)
    np.testing.assert_array_equal(pts, ref.point(pq))
    assert pts[:500].all()          # no false negative
    if ranges:
        got = port.range(lo, hi)
        np.testing.assert_array_equal(got, ref.range(lo, hi))
        assert not (brute_force_range_truth(keys, lo, hi) & ~got).any()


def test_shared_hashing_equals_the_reference():
    x = np.random.default_rng(3).integers(0, 1 << 63, 4096, dtype=np.uint64)
    for seed in (0, 7, 0x0B100F11):
        np.testing.assert_array_equal(PF.api.mix64_np(x, seed),
                                      RF.api.mix64_np(x, seed))
        np.testing.assert_array_equal(PF.api.seeds_np(seed, 9),
                                      RF.api.seeds_np(seed, 9))
    assert isinstance(PF.BloomFilter(), PF.PointRangeFilter)


@pytest.mark.parametrize("d,mode", [(32, "basic"), (64, "basic"),
                                    (32, "tuned")])
def test_bloomrf_adapter_equals_the_reference(d, mode):
    keys, lo, hi, pq = _data(bits=d - 1, n=8000)
    kw = dict(bits_per_key=16, d=d, mode=mode,
              R=2.0 ** (20 if mode == "tuned" else 10))
    ref = RF.BloomRFAdapter(**kw)
    port = PF.BloomRFAdapter(device="cpu", **kw)
    ref.build(keys)
    port.build(keys)
    assert port.handle.spec.backend == "auto"
    assert port.handle.backend == "xla"      # the plain path on the CPU
    assert dataclasses.asdict(port.layout) == dataclasses.asdict(ref.layout)
    np.testing.assert_array_equal(port.handle.state_numpy(),
                                  np.asarray(ref.state).view(np.uint32))
    got = port.point(pq)
    np.testing.assert_array_equal(got, np.asarray(ref.point(pq)))
    np.testing.assert_array_equal(port.range(lo, hi),
                                  np.asarray(ref.range(lo, hi)))
    assert got[:500].all() and port.size_bits() == ref.size_bits()
    more = keys[:100] ^ np.uint64(1)
    ref.insert_more(more)
    port.insert_more(more)
    np.testing.assert_array_equal(port.handle.state_numpy(),
                                  np.asarray(ref.state).view(np.uint32))


# ---------------------------------------------------------------------------
# host baselines as the store's filter backend
# ---------------------------------------------------------------------------

_STORE = dict(d=32, memtable_limit=256, level0_runs=2, fanout=4,
              bits_per_key=14.0)


def _store_stream(seed: int = 0xBA5E, scans: bool = True):
    """Puts of 2,000 32-bit keys with deletes, a ``get_many`` and a
    ``scan_many`` (near and random bounds up to 2^14) after each third,
    then a final flush.  A plain Bloom filter answers no ranges (in either
    package), so its stream takes the gets alone."""
    rng = np.random.default_rng(seed)
    ops, live = [], []
    for i in range(2000):
        if live and rng.random() < 0.15:
            ops.append(("del", live.pop(int(rng.integers(len(live))))))
        else:
            k = int(rng.integers(0, 1 << 32))
            ops.append(("put", k, i))
            live.append(k)
        if i % 700 == 699:
            ks = np.asarray(live, np.uint64)
            q = np.concatenate([rng.choice(ks, 100),
                                rng.integers(0, 1 << 32, 28, dtype=np.uint64)])
            lo = np.concatenate([rng.choice(ks, 64) - np.uint64(5),
                                 rng.integers(0, 1 << 32, 64,
                                              dtype=np.uint64)])
            hi = np.minimum(lo + rng.integers(0, 1 << 14, 128,
                                              dtype=np.uint64),
                            np.uint64((1 << 32) - 1))
            ops += [("get", q)] + ([("scan", lo, hi)] if scans else [])
    ops.append(("flush",))
    return ops


def _drive(store, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2])
        elif op[0] == "del":
            store.delete(op[1])
        elif op[0] == "flush":
            store.flush()
        elif op[0] == "get":
            out.append(store.get_many(op[1]))
        else:
            out.append(store.scan_many(op[1], op[2]))
    return out


@pytest.mark.parametrize("backend", ["bloom", "prefix_bloom", "rosetta",
                                     "surf"])
def test_baseline_store_stream_equals_the_reference(backend):
    ops = _store_stream(scans=backend != "bloom")
    ref = RStore(RConfig(filter_backend=backend, **_STORE), _warn=False)
    port = Store(StoreConfig(filter_backend=backend, **_STORE),
                 device="cpu")
    want = _drive(ref, ops)
    assert _drive(port, ops) == want
    st = port.stats.as_dict()
    assert st == ref.stats.as_dict()
    assert st["rebuild_merges"] == st["compactions"] > 0
    assert st["get_filter_skips"] > 0 and port.filter_builds == 0
    for a, b in zip(port.live_runs(), ref.live_runs()):
        assert a.state is None and b.state is None
        _same(a.alt, b.alt)
    assert port._scan_kernel_mode() == "xla"
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="host-side baseline"):
        port.scan_probe_device(z, z)
    if backend == "bloom":
        with pytest.raises(NotImplementedError, match="ranges"):
            port.scan(0, 10)
    # each package restores the other's snapshot, rebuilding the baselines
    q = next(op for op in ops if op[0] == "get")[1]
    expect = port.get_many(q)
    for snap, restore in ((ref.snapshot(), lambda s: Store.restore(
                               s, device="cpu")),
                          (port.snapshot(), RStore.restore)):
        back = restore(pickle.loads(pickle.dumps(snap)))
        assert back.get_many(q) == expect
        for a, b in zip(back.live_runs(), port.live_runs()):
            _same(a.alt, b.alt)


# ---------------------------------------------------------------------------
# the str and multiattr typed stores
# ---------------------------------------------------------------------------

_TYPED = dict(placement="store", memtable_limit=256, level0_runs=2,
              fanout=4, backend="xla")


def _pair(dtype, tmp_path=None):
    kw = dict(_TYPED, dtype=dtype)
    if tmp_path is not None:
        kw["durability"] = "wal"
    ref = repro.open_filter(repro.FilterSpec(
        **kw, **({"wal_dir": str(tmp_path / "r")} if tmp_path else {})))
    _fast_builds(ref.store)
    port = repro_torch.open_filter(repro_torch.FilterSpec(
        **kw, **({"wal_dir": str(tmp_path / "p")} if tmp_path else {})),
        device="cpu")
    return ref, port


def _words(n: int, seed: int = 17) -> list:
    """Short random words (prefix collisions included) and YCSB keys."""
    pr = random.Random(seed)
    words = {"".join(pr.choices("abcxyz", k=pr.randint(0, 9)))
             for _ in range(n // 2)}
    words |= {f"user{pr.randrange(10 ** 12):012d}" for _ in range(n // 2)}
    return sorted(words)


def test_str_store_equals_the_reference(tmp_path):
    words = _words(600)
    ref, port = _pair("str", tmp_path)
    pr = random.Random(5)
    order = words[:]
    pr.shuffle(order)
    for h in (ref, port):
        for i, w in enumerate(order):
            h.put(w, i)
        for w in order[:40]:                # read-modify-write of buckets
            h.delete(w)
        h.delete_many(order[40:80] + ["never-stored"])
    assert (tmp_path / "p" / WAL_FILENAME).read_bytes() == \
        (tmp_path / "r" / WAL_FILENAME).read_bytes()
    live = sorted(order[80:])
    model = {w: order.index(w) for w in live}
    assert port.get_many(words) == ref.get_many(words) == \
        [model.get(w) for w in words]
    los, his = [], []
    for _ in range(150):
        i = pr.randrange(len(live))
        j = min(i + pr.randrange(25), len(live) - 1)
        los.append(live[i][:pr.randint(0, len(live[i]))])
        his.append(live[j] + "~" * pr.randint(0, 1))
    got = port.scan_many(los, his)
    assert got == ref.scan_many(los, his)
    for rows, lo, hi in zip(got, los, his):     # a sorted oracle
        assert rows == [(w, model[w]) for w in live if lo <= w <= hi]
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert _runs(port.store) == _runs(ref.store)
    # each package opens the other's checkpoint
    ref.checkpoint()
    port.checkpoint()
    ref.close()
    port.close()
    from_ref = Store.open(str(tmp_path / "r"), device="cpu")
    from_port = RStore.open(str(tmp_path / "p"))
    codes = port.codec.encode_point(words[:200])
    assert from_ref.get_many(codes) == from_port.get_many(codes) == \
        port.store.get_many(codes)
    assert _runs(from_ref) == _runs(from_port)
    from_ref.close()
    from_port.close()


def test_multiattr_store_equals_the_reference():
    rng = np.random.default_rng(23)
    n = 1500
    a = rng.integers(0, 1 << 6, n, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    ref, port = _pair("multiattr")
    for h in (ref, port):
        for i in range(n):
            h.put((int(a[i]), int(b[i])), i)
        for i in range(0, 60, 3):
            h.delete((int(a[i]), int(b[i])))
        h.delete_many((a[60:90], b[60:90]))
        h.flush()
    model = {}
    for i in range(n):
        model[(int(a[i]), int(b[i]))] = i
    for i in list(range(0, 60, 3)) + list(range(60, 90)):
        model.pop((int(a[i]), int(b[i])), None)
    qa = a[:200]
    blo = np.maximum(b[:200], 1 << 20) - np.uint64(1 << 20)
    bhi = np.minimum(b[:200] + np.uint64(1 << 20), np.uint64((1 << 32) - 1))
    got = port.scan_many((qa, blo), (qa, bhi))
    assert len(got) == 200 and got == ref.scan_many((qa, blo), (qa, bhi))
    for rows, x, lo, hi in zip(got, qa.tolist(), blo.tolist(), bhi.tolist()):
        assert rows == sorted((k, v) for k, v in model.items()
                              if k[0] == x and lo <= k[1] <= hi)
    assert port.get_many((a[:100], b[:100])) == \
        ref.get_many((a[:100], b[:100]))
    assert port.get((int(a[0]), int(b[0]))) is None
    assert ref.get((int(a[0]), int(b[0]))) is None
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert _runs(port.store) == _runs(ref.store)
