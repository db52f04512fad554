"""64-bit key domains in the port against ``repro`` on the CPU, bit for bit:
``mix64`` and the unsigned helpers on int64 carriers, ``BloomRF`` states and
verdicts over ``d = 64`` layout classes with the edge bounds, the façade's
``u64``/``f64``/``str``/``multiattr`` filters (``range_where_b`` too), one
shared ``d = 64`` store op stream, and the two float zeros (ROADMAP C.2).

The reference runs each layout and handle once per module (its compiles are
shared by the tests that read them); keys and queries come from seeded
numpy generators, never from the shared ``rng`` fixture of conftest.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
from conftest import brute_force_range_truth
from repro.core import BloomRF as JBloomRF
from repro.core import FilterLayout as JLayout
from repro.core import hashing as jhash
from repro.core.engine import _filter_for_layout
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro_torch.core import BloomRF, FilterLayout
from repro_torch.core import hashing as thash
from repro_torch.core import uint64 as u64
from repro_torch.store import Store, StoreConfig

TOP = (1 << 64) - 1
HALF = 1 << 63


def _edges(n: int) -> np.ndarray:
    """Values at the edges of the unsigned order, with the top bit set and
    clear, then ``n`` uniform ones."""
    rng = np.random.default_rng(0x64)
    return np.concatenate([
        np.asarray([0, 1, 2, HALF - 1, HALF, HALF + 1, TOP - 1, TOP],
                   np.uint64),
        rng.integers(0, TOP, n, dtype=np.uint64, endpoint=True)])


def test_mix64_and_unsigned_helpers_match_repro_and_numpy():
    x = _edges(4000)
    t = u64.carrier(x)
    np.testing.assert_array_equal(
        thash.mix64(t).numpy().view(np.uint64),
        np.asarray(jhash.mix64(jnp.asarray(x, jnp.uint64))))
    np.testing.assert_array_equal(
        thash.mix(t, np.uint64(0xDEADBEEFCAFEF00D), 64).numpy().view(
            np.uint64),
        np.asarray(jhash.mix(jnp.asarray(x, jnp.uint64),
                             np.uint64(0xDEADBEEFCAFEF00D), 64)))
    np.testing.assert_array_equal(
        thash.dyadic_prefixes(t, 40, 64).numpy(),
        np.asarray(jhash.dyadic_prefixes(jnp.asarray(x, jnp.uint64), 40,
                                         64)).astype(np.int64))
    y = np.roll(x, 3)
    ty = u64.carrier(y)
    np.testing.assert_array_equal(u64.le(t, ty).numpy(), x <= y)
    np.testing.assert_array_equal(u64.ge(t, ty).numpy(), x >= y)
    as_u = lambda v: v.numpy().view(np.uint64)     # noqa: E731
    np.testing.assert_array_equal(as_u(u64.minimum(t, ty)), np.minimum(x, y))
    np.testing.assert_array_equal(as_u(u64.maximum(t, ty)), np.maximum(x, y))
    lo, hi = np.minimum(x, y), np.maximum(x, y)
    z = np.roll(x, 7)
    np.testing.assert_array_equal(
        as_u(u64.clamp(u64.carrier(z), u64.carrier(lo), u64.carrier(hi))),
        np.clip(z, lo, hi))
    for s in (0, 1, 31, 32, 63):
        np.testing.assert_array_equal(as_u(u64.shr(t, s)),
                                      x >> np.uint64(s))
    assert not u64.shr(t, 64).any()
    for n in (1, 3, 1000, (1 << 31) - 1):
        np.testing.assert_array_equal(u64.mod(t, n).numpy(),
                                      (x % np.uint64(n)).astype(np.int64))
    with pytest.raises(ValueError, match="modulus"):
        u64.mod(t, 1 << 31)


#: d = 64 layout classes beside the façade's basic Δ = 7 one: Δ = 4 (words
#: inside a lane) over two segments with replicas, W = 64 words with
#: replicas, an exact segment under seven hashed layers
_LAYOUTS = {
    "delta4_segments": JLayout(d=64, deltas=(4, 4, 4), replicas=(1, 2, 1),
                               seg_of_layer=(0, 1, 0),
                               seg_bits=(8192, 4096)),
    "w64_replicas": JLayout(d=64, deltas=(7, 7), replicas=(1, 2),
                            seg_of_layer=(0, 0), seg_bits=(16384,)),
    "exact": JLayout(d=64, deltas=(7,) * 7, replicas=(1,) * 7,
                     seg_of_layer=(0,) * 7, seg_bits=(1 << 14, 1 << 15),
                     exact_seg=1, seed=5),
}


def _bounds(keys: np.ndarray) -> tuple:
    """Ranges of log-uniform length from uniform starts, then the edges:
    the whole domain, lo = hi = 0 and = 2^64 - 1, lo > hi, a split at the
    top bit, and point ranges on stored keys."""
    rng = np.random.default_rng(7)
    lo = rng.integers(0, TOP, 1500, dtype=np.uint64, endpoint=True)
    hi = lo + np.floor(np.exp2(rng.uniform(0, 40, 1500))).astype(np.uint64)
    hi = np.where(hi < lo, np.uint64(TOP), hi)
    edges = [(0, TOP), (0, 0), (TOP, TOP), (TOP, 0), (9, 2),
             (HALF - 1, HALF), (HALF, HALF - 1), (HALF - 5, HALF + 5)]
    lo[:8] = [a for a, _ in edges]
    hi[:8] = [b for _, b in edges]
    lo[8:12] = hi[8:12] = keys[:4]
    return lo, hi


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_bloomrf_states_and_verdicts_match_reference(name):
    jl = _LAYOUTS[name]
    jf = JBloomRF(jl, _warn=False)
    tf = BloomRF(FilterLayout.from_dict(dataclasses.asdict(jl)), device="cpu")
    keys = _edges(2000)
    js = jax.jit(jf.insert)(jf.init_state(), jnp.asarray(keys, jnp.uint64))
    state = tf.insert(tf.init_state(), u64.carrier(keys))
    np.testing.assert_array_equal(state.numpy().view(np.uint32),
                                  np.asarray(js))
    qs = np.concatenate([keys[:500], _edges(1000)[8:]])
    want = np.asarray(jax.jit(jf.point)(js, jnp.asarray(qs, jnp.uint64)))
    np.testing.assert_array_equal(tf.point(state, u64.carrier(qs)).numpy(),
                                  want)
    assert want[:500].all()
    lo, hi = _bounds(keys)
    want = np.asarray(jax.jit(jf.range)(js, jnp.asarray(lo, jnp.uint64),
                                        jnp.asarray(hi, jnp.uint64)))
    tlo, thi = u64.carrier(lo), u64.carrier(hi)
    np.testing.assert_array_equal(tf.range(state, tlo, thi).numpy(), want)
    np.testing.assert_array_equal(
        tf.range_reference(state, tlo, thi).numpy(), want)
    ok = lo <= hi
    truth = brute_force_range_truth(keys, lo[ok], hi[ok])
    assert not (truth & ~want[ok]).any()


# ---------------------------------------------------------------------------
# the façade
# ---------------------------------------------------------------------------

def _typed(dtype: str, rng, n: int):
    """Keys and (lo, hi) bounds of ``dtype``; the float keys hold both
    zeros and both infinities."""
    if dtype == "u64":
        keys = _edges(n - 8)
        return keys, _bounds(keys)
    if dtype == "f64":
        keys = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 5e-324],
                               rng.normal(0, 1e6, n - 5)])
        lo = np.concatenate([[-0.0, 0.0, -1.0], rng.normal(0, 1e6, 509)])
        return keys, (lo, lo + rng.exponential(100.0, 512))
    if dtype == "str":
        keys = [f"user{int(k):012d}" for k in rng.integers(0, 10**9, n)]
        lo = [f"user{int(k):012d}" for k in rng.integers(0, 10**9, 512)]
        return keys, (lo, [s[:-3] + "zzz" for s in lo])
    a = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    qa = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    qb = rng.integers(0, 1 << 32, 512, dtype=np.uint64)
    return np.stack([a, b]), (np.stack([qa, qb]),
                              np.stack([qa, qb + np.uint64(1 << 20)]))


@functools.lru_cache(maxsize=None)
def _facade(dtype: str):
    """One ``repro`` handle (``backend="xla"``) and the port's on the CPU,
    filled with the same keys; with the keys and the bounds."""
    rng = np.random.default_rng(0x64F)
    kw = dict(dtype=dtype, n=3000)
    ref = repro.open_filter(repro.FilterSpec(backend="xla", **kw))
    port = repro_torch.open_filter(repro_torch.FilterSpec(**kw), device="cpu")
    keys, bounds = _typed(dtype, rng, 3000)
    ref.insert(keys)
    port.insert(keys)
    return ref, port, keys, bounds


@pytest.mark.parametrize("dtype", ["u64", "f64", "str", "multiattr"])
def test_facade_matches_reference(dtype):
    ref, port, keys, (lo, hi) = _facade(dtype)
    assert port.codec.d == 64 and port.backend == "xla"
    assert port.layout == FilterLayout.from_dict(
        dataclasses.asdict(ref.layout))
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    want = ref.range(lo, hi)
    np.testing.assert_array_equal(port.range(lo, hi), want)
    qs = keys[:, :512] if dtype == "multiattr" else keys[:512]
    wp = ref.point(qs)
    np.testing.assert_array_equal(port.point(qs), wp)
    assert wp.all()
    if dtype == "multiattr":
        b_const, a_lo = keys[1, :512], keys[0, :512]
        a_hi = a_lo + np.uint64(9)
        got = port.range_where_b(b_const, a_lo, a_hi)
        np.testing.assert_array_equal(got, ref.range_where_b(b_const, a_lo,
                                                             a_hi))
        assert got.all()
    else:
        with pytest.raises(TypeError, match="multiattr"):
            port.range_where_b(1, 2, 3)
    # a reference state carries into the port
    carried = repro_torch.open_filter(port.spec, device="cpu")
    carried.load_state(np.asarray(ref.state))
    np.testing.assert_array_equal(carried.range(lo, hi), want)


def test_default_spec_is_u64_and_forced_kernels_refuse_it():
    h = repro_torch.open_filter(repro_torch.FilterSpec(n=1000), device="cpu")
    assert h.spec.dtype == "u64" and h.codec.d == 64 and h.backend == "xla"
    h.insert([0, TOP, HALF])
    assert h.point([0, TOP, HALF]).all()
    for backend in ("resident", "partitioned"):
        with pytest.raises(ValueError, match="32-bit sub-domains"):
            repro_torch.open_filter(repro_torch.FilterSpec(
                n=1000, backend=backend), device="cpu")


def test_float_zeros_are_different_keys_in_both_packages():
    """ROADMAP C.2, decided for bit-identity: -0.0 and +0.0 map to
    different codes in f32 and f64, in both packages, so a filter holding
    one answers for the other only by a false positive."""
    from repro import api as rapi
    from repro_torch import api as tapi

    for dtype, zero_codes in (("f32", (0x7FFFFFFF, 0x80000000)),
                              ("f64", ((1 << 63) - 1, 1 << 63))):
        tc, rc = tapi._codec_for(dtype), rapi._codec_for(dtype)
        codes = tc.encode_point([-0.0, 0.0])
        np.testing.assert_array_equal(codes, rc.encode_point([-0.0, 0.0]))
        assert tuple(int(c) for c in codes) == zero_codes
    ref, port, _, (lo, hi) = _facade("f64")
    q = np.concatenate([[-0.0, 0.0], lo[2:]])      # the façade test's shape
    np.testing.assert_array_equal(port.point(q), ref.point(q))
    np.testing.assert_array_equal(port.range(q, q), ref.range(q, q))


# ---------------------------------------------------------------------------
# the d = 64 store
# ---------------------------------------------------------------------------

def _store_stream():
    """Puts, deletes, gets and scans of 64-bit keys (a fifth with the top
    bit set), through flushes, OR and rebuild merges; scans 256 codes wide
    and over the top bit, the whole domain and point scans."""
    rng = np.random.default_rng(0x5764)
    pool = rng.integers(0, TOP, 900, dtype=np.uint64, endpoint=True)
    pool[:4] = [0, TOP, HALF, HALF - 1]
    ops = []
    for i in range(450):
        if i % 11 == 10:
            ops.append(("del", int(pool[rng.integers(0, 900)])))
        else:
            ops.append(("put", int(pool[rng.integers(0, 900)]), i))
    lo = rng.integers(0, TOP - 255, 256, dtype=np.uint64)
    lo[:32] = pool[rng.integers(0, 900, 32)] - np.uint64(100)
    hi = lo + np.uint64(255)
    lo[:4] = [0, HALF - 10, 0, TOP]
    hi[:4] = [TOP, HALF + 10, 0, TOP]
    return ops + [("scan", lo, hi), ("get", np.concatenate(
        [pool[:400], rng.integers(0, TOP, 100, dtype=np.uint64)]))]


def _drive(store, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            store.put(op[1], op[2])
        elif op[0] == "del":
            store.delete(op[1])
        elif op[0] == "get":
            out.append(store.get_many(op[1]))
        else:
            out.append(store.scan_many(op[1], op[2]))
    return out


_STORE = dict(d=64, memtable_limit=64, level0_runs=2, fanout=2)


@functools.lru_cache(maxsize=None)
def _jit_build(layout):
    return jax.jit(_filter_for_layout(layout).build)


def _jitted_builds(store) -> None:
    """The reference store's own ``BloomRF.build`` under ``jax.jit``: the
    same function (its d = 64 builds take no kernel), compiled once per key
    count instead of once per primitive."""
    store._build_filter = lambda layout, keys: _jit_build(layout)(
        jnp.asarray(keys, jnp.uint64))


@functools.lru_cache(maxsize=None)
def _reference_store():
    st = RStore(RConfig(scan_backend="xla", **_STORE), _warn=False)
    _jitted_builds(st)
    return _drive(st, _store_stream()), st


@pytest.mark.parametrize("scan_backend", ["auto", "kernel"])
def test_d64_store_op_stream_matches_reference(scan_backend):
    """Scans, gets, stats and run states; at d = 64 the store builds, gets
    and scans on the plain path under every ``scan_backend``, as the
    reference does (no kernel takes these layouts)."""
    want, ref = _reference_store()
    stats = ref.stats.as_dict()
    assert stats["or_merges"] > 0 and stats["rebuild_merges"] > 0
    st = Store(StoreConfig(scan_backend=scan_backend, **_STORE),
               device="cpu")
    assert st._scan_kernel_mode() == "xla"
    assert _drive(st, _store_stream()) == want
    assert sum(map(len, want[0])) > 0
    assert st.stats.as_dict() == stats
    assert [r.layout for r in st.live_runs()] == [
        FilterLayout.from_dict(dataclasses.asdict(r.layout))
        for r in ref.live_runs()]
    for a, b in zip(st.live_runs(), ref.live_runs()):
        np.testing.assert_array_equal(a.state_numpy(), np.asarray(b.state))
        np.testing.assert_array_equal(a.keys, b.keys)
    # the device plane on the same bounds equals the host plane
    lo, hi = next(op for op in _store_stream() if op[0] == "scan")[1:]
    fence, touch = st.scan_probe_device(u64.carrier(lo), u64.carrier(hi))
    f2, t2 = st._touch_masks(lo, hi)
    np.testing.assert_array_equal(fence.numpy(), f2)
    np.testing.assert_array_equal(touch.numpy(), t2)


@pytest.mark.parametrize("dtype", ["u64", "f64"])
def test_typed_d64_store_matches_reference(dtype):
    rng = np.random.default_rng(11)
    if dtype == "u64":
        keys = rng.integers(0, TOP, 300, dtype=np.uint64, endpoint=True)
        lo = rng.integers(0, TOP - (1 << 62), 32, dtype=np.uint64)
        hi, as_key = lo + np.uint64(1 << 62), int
    else:
        keys = np.concatenate([[-0.0, 0.0], rng.normal(0, 1e3, 298)])
        lo = np.concatenate([[-0.0], rng.normal(0, 1e3, 31)])
        hi, as_key = lo + 300.0, float
    kw = dict(dtype=dtype, placement="store", memtable_limit=128,
              level0_runs=4, fanout=2, backend="xla")
    ref = repro.open_filter(repro.FilterSpec(**kw))
    _jitted_builds(ref.store)
    port = repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                   device="cpu")
    for i, k in enumerate(keys):
        ref.put(as_key(k), i)
        port.put(as_key(k), i)
    got = port.scan_many(lo, hi)
    assert got == ref.scan_many(lo, hi) and sum(map(len, got)) > 0
    assert port.get_many(keys[:20]) == ref.get_many(keys[:20])
    assert port.stats.as_dict() == ref.stats.as_dict()
    assert port.size_bits() == ref.size_bits()
