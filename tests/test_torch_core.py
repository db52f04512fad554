"""The port's ``BloomRF`` and ``ProbeEngine`` against ``repro``'s on the CPU:
bit-identical states, identical point and range verdicts, over the layout
classes of tests/test_engine.py, plus the d = 8 exhaustive
no-false-negative check and the edge bounds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import brute_force_range_truth
from repro.core import BloomRF as JBloomRF
from repro.core import FilterLayout as JLayout
from repro.core import basic_layout as jbasic
from repro_torch.core import BloomRF, FilterLayout


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def _pair(jl):
    """The same layout in both packages, with both filters."""
    tl = FilterLayout.from_dict(dataclasses.asdict(jl))
    return JBloomRF(jl, _warn=False), BloomRF(tl, device="cpu")


def _jit_insert(jf, keys):
    """``repro``'s ``BloomRF.insert`` into an empty state (jitted: cheaper
    than op-by-op dispatch on the CPU)."""
    return jax.jit(jf.insert)(jf.init_state(), jnp.asarray(keys, jnp.uint32))


def _random_layout(rng, allow_exact=False):
    """tests/test_engine.py::_random_layout: d <= 32, 2 hashed segments,
    replicas, Δ in 1..7, optionally an exact segment."""
    d = int(rng.integers(16, 33))
    deltas, rem = [], d
    for _ in range(int(rng.integers(2, 5))):
        if rem < 1:
            break
        deltas.append(int(min(rng.integers(1, 8), rem)))
        rem -= deltas[-1]
    k = len(deltas)
    exact_seg = None
    seg_bits = (8192, 4096)
    seg_of_layer = tuple(int(s) for s in rng.integers(0, 2, k))
    if allow_exact and d - sum(deltas) >= 4 and rng.integers(2):
        exact_seg = 2
        seg_bits = (8192, 4096, 1 << (d - sum(deltas)))
    return JLayout(
        d=d, deltas=tuple(deltas),
        replicas=tuple(int(r) for r in rng.integers(1, 3, k)),
        seg_of_layer=seg_of_layer, seg_bits=seg_bits, exact_seg=exact_seg,
        seed=int(rng.integers(1 << 30)))


#: the layout classes of tests/test_engine.py: random layouts (:48, mixed
#: Δ, replicas, two segments, sometimes an exact one), W=64 with replicas
#: (:93), an exact segment (:101) and several segments (:185); plus a layout
#: whose levels cover all 32 bits (top_level == d) and basic layouts for the
#: Δ those classes leave out (1, 3, 5; on a 16-bit domain to keep the
#: reference's eager cost down)
_CLASSES = {
    **{f"delta{dl}": (lambda dl=dl: jbasic(16, 300, 14.0, delta=dl))
       for dl in (1, 3, 5, 6)},
    "w64_replicas": lambda: JLayout(d=32, deltas=(7, 7), replicas=(1, 2),
                                    seg_of_layer=(0, 0), seg_bits=(16384,)),
    "exact": lambda: JLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
                             seg_of_layer=(2, 2, 1, 1),
                             seg_bits=(1 << 12, 4096, 8192), exact_seg=0),
    "multiseg": lambda: JLayout(d=32, deltas=(6, 5, 4), replicas=(2, 1, 2),
                                seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096)),
    "top_eq_d": lambda: jbasic(32, 2, 16.0),
    **{f"random{t}": (lambda t=t: _random_layout(
        np.random.default_rng(0xEA5E + t), allow_exact=True))
       for t in range(2)},
}


def _queries(rng, d, n_q):
    """Random ranges plus the edge bounds: lo = 0 with hi = 2^d - 1, lo = hi
    at both ends of the domain, lo > hi, and ranges touching 0 and the top,
    where the reference's uint32 arithmetic wraps."""
    hi_excl = 1 << d
    lo = rng.integers(0, hi_excl, n_q, dtype=np.uint64)
    span = rng.integers(0, 1 << min(d - 1, 14), n_q, dtype=np.uint64)
    hi = np.minimum(lo + span, hi_excl - 1)
    top = hi_excl - 1
    edge_lo = np.array([0, 0, top, 5, 9, top, 0, top - 1], np.uint64)
    edge_hi = np.array([top, 0, top, 5, 2, 0, 1, top], np.uint64)
    return np.concatenate([lo, edge_lo]), np.concatenate([hi, edge_hi])


@pytest.mark.parametrize("name", list(_CLASSES))
def test_states_and_verdicts_match_reference(name):
    """States equal ``repro``'s insert; the port's scalar path and engine
    give ``repro``'s verdicts (``repro``'s engine, which its own tests hold
    to its scalar path; the scalar path itself is checked below)."""
    jl = _CLASSES[name]()
    jf, tf = _pair(jl)
    rng = np.random.default_rng(0xC0DE)
    d = jl.d
    keys = rng.integers(0, 1 << d, 1024, dtype=np.uint64)
    jstate = _jit_insert(jf, keys)
    tstate = tf.build(_i64(keys))
    np.testing.assert_array_equal(tstate.numpy(),
                                  np.asarray(jstate).view(np.int32))
    lo, hi = _queries(rng, d, 2040)
    want = np.asarray(jf.range(jstate, jnp.asarray(lo, jnp.uint32),
                               jnp.asarray(hi, jnp.uint32)))
    np.testing.assert_array_equal(
        tf.range_reference(tstate, _i64(lo), _i64(hi)).numpy(), want)
    np.testing.assert_array_equal(tf.range(tstate, _i64(lo), _i64(hi)).numpy(),
                                  want)
    # swapped bounds are allowed and give the same verdicts
    np.testing.assert_array_equal(tf.range(tstate, _i64(hi), _i64(lo)).numpy(),
                                  want)
    qs = np.concatenate([keys[:300], lo[:1748]])
    wp = np.asarray(jax.jit(jf.point)(jstate, jnp.asarray(qs, jnp.uint32)))
    np.testing.assert_array_equal(tf.point_reference(tstate, _i64(qs)).numpy(),
                                  wp)
    np.testing.assert_array_equal(tf.point(tstate, _i64(qs)).numpy(), wp)
    assert wp[:300].all()


@pytest.mark.parametrize("name", ["exact"])
def test_scalar_paths_match_reference_scalar_paths(name):
    """The port's point_reference / range_reference against ``repro``'s."""
    jl = _CLASSES[name]()
    jf, tf = _pair(jl)
    rng = np.random.default_rng(0x5CA1)
    keys = rng.integers(0, 1 << jl.d, 1024, dtype=np.uint64)
    tstate = tf.build(_i64(keys))
    jstate = jnp.asarray(tstate.numpy().view(np.uint32))
    lo, hi = _queries(rng, jl.d, 2040)
    want = np.asarray(jax.jit(jf.range_reference)(
        jstate, jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32)))
    np.testing.assert_array_equal(
        tf.range_reference(tstate, _i64(lo), _i64(hi)).numpy(), want)
    wp = np.asarray(jax.jit(jf.point_reference)(jstate,
                                                jnp.asarray(lo, jnp.uint32)))
    np.testing.assert_array_equal(
        tf.point_reference(tstate, _i64(lo)).numpy(), wp)


@pytest.mark.parametrize("name", ["delta6", "w64_replicas", "exact"])
def test_insert_paths_bit_identical(name):
    """Both scatter_or paths and insert_online give ``repro``'s insert."""
    jl = _CLASSES[name]()
    jf, tf = _pair(jl)
    rng = np.random.default_rng(0x5CA7)
    keys = rng.integers(0, 1 << jl.d, 1024, dtype=np.uint64)
    want = np.asarray(_jit_insert(jf, keys)).view(np.int32)
    pos = tf.positions(_i64(keys))
    st = tf.init_state()
    np.testing.assert_array_equal(tf.scatter_or(st, pos).numpy(), want)
    np.testing.assert_array_equal(tf.scatter_or(st, pos, bitmap=True).numpy(),
                                  want)
    np.testing.assert_array_equal(tf.insert_online(st, _i64(keys)).numpy(),
                                  want)
    # the vals mask drops positions the same way on both scatter_or paths
    vals = torch.from_numpy(rng.integers(0, 2, pos.shape).astype(bool))
    np.testing.assert_array_equal(
        tf.scatter_or(st, pos, vals).numpy(),
        tf.scatter_or(st, pos, vals, bitmap=True).numpy())
    np.testing.assert_array_equal(
        tf.scatter_or(st, pos, vals).numpy(),
        tf.scatter_or(st, pos[vals]).numpy())


@pytest.mark.parametrize("delta", [1, 2, 3, 4, 5, 6, 7])
def test_exhaustive_no_false_negatives_small_domain(rng, delta):
    """tests/test_bloomrf_core.py:20 on the port: every range of an 8-bit
    domain, and the verdicts equal the reference's."""
    d = 8
    keys = np.unique(rng.integers(0, (1 << d) - 1, 12, dtype=np.uint64))
    jl = jbasic(d, len(keys), bits_per_key=14.0, delta=delta)
    tf = _pair(jl)[1]
    state = tf.build(_i64(keys))
    los, his = np.meshgrid(np.arange(1 << d, dtype=np.uint64),
                           np.arange(1 << d, dtype=np.uint64))
    mask = los.ravel() <= his.ravel()
    lo, hi = los.ravel()[mask], his.ravel()[mask]
    res = tf.range(state, _i64(lo), _i64(hi)).numpy()
    truth = brute_force_range_truth(keys, lo, hi)
    assert not (truth & ~res).any(), "range false negative"
    pq = np.arange(1 << d, dtype=np.uint64)
    pres = tf.point(state, _i64(pq)).numpy()
    assert pres[np.isin(pq, keys)].all(), "point false negative"


@pytest.mark.parametrize("name", ["delta6", "w64_replicas", "exact",
                                  "multiseg"])
def test_access_model_matches(name):
    jl = _CLASSES[name]()
    jf, tf = _pair(jl)
    assert tf.word_accesses_per_range_query() == \
        jf.word_accesses_per_range_query()
    assert tf.word_accesses_per_point_query() == \
        jf.word_accesses_per_point_query()
    assert tf.engine.range_word_loads == jf.engine.range_word_loads
    assert tf.engine.range_gather_width == jf.engine.range_gather_width
    lo = _i64([3, 1 << 20])
    plan = tf.engine.plan_range(lo, lo + 99)
    assert plan.lanes.shape == (2, tf.engine.range_gather_width)
    jplan = jf.engine.plan_range(jnp.asarray([3, 1 << 20], jnp.uint32),
                                 jnp.asarray([102, (1 << 20) + 99], jnp.uint32))
    np.testing.assert_array_equal(plan.lanes.numpy(), np.asarray(jplan.lanes))


def test_exact_middle_scan_cap_answers_true():
    """Ranges wider than max_exact_scan_lanes answer True (the reference's
    over-cap rule); narrower ones scan."""
    jl = JLayout(d=32, deltas=(7, 7, 7, 4), replicas=(1, 1, 1, 1),
                 seg_of_layer=(1, 1, 1, 1), seg_bits=(128, 4096), exact_seg=0,
                 max_exact_scan_lanes=2)
    jf, tf = _pair(jl)
    rng = np.random.default_rng(0xCA9)
    st = tf.build(_i64(rng.integers(0, 1 << 32, 1024, dtype=np.uint64)))
    rlo, rhi = _queries(rng, 32, 2036)
    lo = _i64(np.concatenate([[0, 0, 1 << 26, 1 << 28], rlo]))
    hi = _i64(np.concatenate([[(1 << 32) - 1, 1 << 27, (1 << 26) + 5000,
                               (1 << 29) + 100], rhi]))
    jst = jnp.asarray(st.numpy().view(np.uint32))
    want = np.asarray(jf.range(jst, jnp.asarray(lo.numpy(), jnp.uint32),
                               jnp.asarray(hi.numpy(), jnp.uint32)))
    np.testing.assert_array_equal(tf.range(st, lo, hi).numpy(), want)
    assert want[0]
