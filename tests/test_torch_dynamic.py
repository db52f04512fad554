"""The port's ``core/dynamic.py`` and the façade's ``grow`` / ``delete`` /
TTL against ``repro``'s on the same inputs, bit for bit: promoted layouts,
states and counters, counting lanes, bit clearing, generation lanes, the
deletable filter, and u16/u32 single filters through growth, deletes and
generation advances (states, counters, generations and verdicts), with a
``repro`` handle's counters and generations carried into the port.  Inputs
come from numpy seeds; states are built with the port's insert, which
equals the reference's (tests/test_torch_core.py), so the reference
compiles only where the façade runs it."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import BloomRF as JBloomRF
from repro.core import basic_layout as jbasic
from repro.core import dynamic as jdyn
from repro_torch.core import (CountingLanes, DeletableBloomRF, FilterLayout,
                              Generations, clear_bits, promote_counts,
                              promote_layout, promote_state, promotion_factors)
from repro_torch.core.engine import _filter_for_layout

_CPU = torch.device("cpu")


def _port(jl) -> FilterLayout:
    return FilterLayout.from_dict(dataclasses.asdict(jl))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def _u32(state: torch.Tensor) -> np.ndarray:
    return state.numpy().view(np.uint32)


def _exact_layout():
    from repro.core.tuning import advise

    jl = advise(16, 300, 16384, 64.0).layout
    assert jl.has_exact
    return jl


# ---------------------------------------------------------------------------
# promotion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,delta,factor", [(24, 6, 4), (32, 6, 4),
                                            (32, 4, 16), (20, 7, 4),
                                            ("exact", None, 4)])
def test_promotion_matches_reference(d, delta, factor):
    """Promoted layouts, factors, states (with a leading batch dimension)
    and counters equal the reference's."""
    jl = _exact_layout() if d == "exact" else jbasic(d, 512, 14.0,
                                                      delta=delta)
    lay = _port(jl)
    jnew = jdyn.promote_layout(jl, factor)
    new = promote_layout(lay, factor)
    assert new == _port(jnew)
    assert promotion_factors(lay, new) == jdyn.promotion_factors(jl, jnew)
    rng = np.random.default_rng(0xD1A0 + factor)
    f = _filter_for_layout(lay, _CPU)
    states = torch.stack([f.build(_t(rng.integers(0, 1 << lay.d, 700,
                                                  dtype=np.uint64)))
                          for _ in range(2)])
    want = np.asarray(jdyn.promote_state(jnp.asarray(_u32(states)), jl,
                                         jnew))
    np.testing.assert_array_equal(_u32(promote_state(states, lay, new)),
                                  want)
    counts = rng.integers(0, 256, lay.total_bits).astype(np.uint8)
    np.testing.assert_array_equal(promote_counts(counts, lay, new),
                                  jdyn.promote_counts(counts, jl, jnew))


def test_promotion_rejects_what_the_reference_rejects():
    old = jbasic(32, 512, 14.0, delta=6, seed=1)
    others = [jbasic(32, 2048, 14.0, delta=6, seed=2),
              jbasic(24, 2048, 14.0, delta=6, seed=1),
              jbasic(32, 2048, 14.0, delta=4, seed=1)]
    for jo in others:
        assert jdyn.promotion_factors(old, jo) is None
        assert promotion_factors(_port(old), _port(jo)) is None
    lay = _port(old)
    with pytest.raises(ValueError, match="promotion-compatible"):
        promote_state(torch.zeros(lay.total_u32, dtype=torch.int32), lay,
                      _port(others[0]))
    with pytest.raises(ValueError, match="factor"):
        promote_layout(lay, 0)


# ---------------------------------------------------------------------------
# counting lanes, bit clearing, generations, the deletable filter
# ---------------------------------------------------------------------------

def test_counting_lanes_match_reference():
    rng = np.random.default_rng(0xC0C0)
    port, ref = CountingLanes(512), jdyn.CountingLanes(512)
    for _ in range(6):
        pos = rng.integers(0, 512, 700)
        port.add(pos)
        ref.add(pos)
        gone = rng.integers(0, 512, 400)
        np.testing.assert_array_equal(port.remove(gone), ref.remove(gone))
        np.testing.assert_array_equal(port.counts, ref.counts)
    # saturation at 255 freezes a counter
    for lanes in (port, ref):
        lanes.add(np.repeat(5, CountingLanes.SATURATE + 10))
        for _ in range(CountingLanes.SATURATE + 10):
            assert list(lanes.remove(np.array([5]))) == []
    assert port.counts[5] == ref.counts[5] == CountingLanes.SATURATE
    with pytest.raises(ValueError):
        CountingLanes(8, counts=np.zeros(9, np.uint8))


def test_clear_bits_matches_reference():
    rng = np.random.default_rng(0xC1EA)
    state = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    pos = np.concatenate([[0, 31, 32, 2047], rng.integers(0, 2048, 300)])
    st = torch.from_numpy(state.view(np.int32).copy())
    np.testing.assert_array_equal(
        _u32(clear_bits(st, pos)),
        np.asarray(jdyn.clear_bits(jnp.asarray(state), pos)))
    assert clear_bits(st, []) is st


def test_generations_match_reference():
    """The same inserts, advances and a promotion on both packages: every
    generation, the current index and the OR-collapse agree."""
    rng = np.random.default_rng(0x6E25)
    jl = jbasic(32, 1024, 14.0, delta=6)
    lay, jnew = _port(jl), jdyn.promote_layout(jl, 4)
    new = _port(jnew)
    f, fnew = _filter_for_layout(lay, _CPU), _filter_for_layout(new, _CPU)
    port = Generations(f.init_state, n_generations=3)
    ref = jdyn.Generations(JBloomRF(jl, _warn=False).init_state, 3)

    def ref_insert(st, keys):
        # the port's insert on the reference's generation (equal bits)
        return jnp.asarray(_u32(f.insert(
            torch.from_numpy(np.asarray(st).view(np.int32).copy()),
            _t(keys))))

    def same():
        assert port.current == ref.current
        assert port.advances == ref.advances
        for a, b in zip(port.gens, ref.gens):
            np.testing.assert_array_equal(_u32(a), np.asarray(b))
        np.testing.assert_array_equal(_u32(port.collapsed),
                                      np.asarray(ref.collapsed))

    for step in range(4):
        keys = rng.integers(0, 1 << 32, 300, dtype=np.uint64)
        port.insert(f.insert, _t(keys))
        ref.insert(ref_insert, keys)
        same()
        port.advance()
        ref.advance()
        same()
    port = port.map(lambda st: promote_state(st, lay, new),
                    zero_fn=fnew.init_state)
    ref = ref.map(lambda st: jdyn.promote_state(st, jl, jnew),
                  zero_fn=JBloomRF(jnew, _warn=False).init_state)
    same()
    port.advance()
    ref.advance()
    same()
    with pytest.raises(ValueError):
        Generations(f.init_state, 1)


def test_deletable_bloomrf_matches_reference():
    rng = np.random.default_rng(0xDE1E)
    jl = jbasic(32, 2048, 14.0, delta=6)
    lay = _port(jl)
    port, ref = DeletableBloomRF(lay, device="cpu"), jdyn.DeletableBloomRF(jl)
    keys = np.unique(rng.integers(0, 1 << 32, 2000, dtype=np.uint64))
    gone, kept = keys[:1000], keys[1000:]
    sp = port.insert(port.init_state(), _t(keys))
    sr = ref.insert(ref.init_state(), jnp.asarray(keys, ref.kdtype))
    np.testing.assert_array_equal(_u32(sp), np.asarray(sr))
    sp = port.delete(sp, _t(gone))
    sr = ref.delete(sr, jnp.asarray(gone, ref.kdtype))
    np.testing.assert_array_equal(_u32(sp), np.asarray(sr))
    np.testing.assert_array_equal(port.counts.counts, ref.counts.counts)
    assert port.point(sp, _t(kept)).all()
    assert port.point(sp, _t(gone)).float().mean() < 0.05
    # promotion carries the counters: deletes still work afterwards
    big, sp = port.promoted(promote_layout(lay, 4), sp)
    jbig, sr = ref.promoted(jdyn.promote_layout(jl, 4), sr)
    sp = big.delete(sp, _t(kept[:100]))
    sr = jbig.delete(sr, jnp.asarray(kept[:100], jbig.kdtype))
    np.testing.assert_array_equal(_u32(sp), np.asarray(sr))
    np.testing.assert_array_equal(big.counts.counts, jbig.counts.counts)
    assert big.point(sp, _t(kept[100:])).all()
    assert big.range(sp, _t(kept[100:]), _t(kept[100:])).all()


# ---------------------------------------------------------------------------
# the façade: grow, delete, TTL
# ---------------------------------------------------------------------------

def _same(ref, h, qs, lo, hi):
    np.testing.assert_array_equal(h.state_numpy(), np.asarray(ref.state))
    assert h.layout == _port(ref.layout)
    if ref.counts is not None:
        np.testing.assert_array_equal(h.counts.counts, ref.counts.counts)
    if ref.gens is not None:
        assert h.gens.current == ref.gens.current
        for a, b in zip(h.gens.gens, ref.gens.gens):
            np.testing.assert_array_equal(_u32(a), np.asarray(b))
    np.testing.assert_array_equal(h.point(qs), ref.point(qs))
    np.testing.assert_array_equal(h.range(lo, hi), ref.range(lo, hi))


@pytest.mark.parametrize("mutability", ["insert_only", "deletable", "ttl"])
@pytest.mark.parametrize("dtype", ["u16", "u32"])
def test_facade_grow_delete_ttl_match_reference(dtype, mutability):
    """One op stream on ``repro``'s façade (``backend="xla"``) and on the
    port's (``auto``, here the plain path, and ``partitioned``, the
    partitioned kernels' plain path), plus a port handle that takes the
    reference's state, counters and generations half way: states, counters,
    generations and verdicts equal after every step."""
    d = int(dtype[1:])
    rng = np.random.default_rng(0xFAC0 + d + len(mutability))
    keys = rng.integers(0, 1 << d, 9000, dtype=np.uint64)
    qs = np.concatenate([keys[:512], rng.integers(0, 1 << d, 512,
                                                  dtype=np.uint64)])
    lo = rng.integers(0, 1 << d, 1024, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 8, 1024, dtype=np.uint64),
                    (1 << d) - 1)
    kw = dict(dtype=dtype, n=3000, mutability=mutability, generations=3)
    ref = repro.open_filter(repro.FilterSpec(backend="xla", **kw))
    handles = [repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                       device="cpu"),
               repro_torch.open_filter(repro_torch.FilterSpec(
                   backend="partitioned", **kw), device="cpu")]
    assert handles[1].ops is not None and not handles[1].ops.resident

    def step(lo_k, hi_k, gone):
        for h in [ref] + handles:
            h.insert(keys[lo_k:hi_k])
            if mutability == "deletable":
                h.delete(gone)
            elif mutability == "ttl":
                h.advance_generation()
        for h in handles:
            _same(ref, h, qs, lo, hi)

    step(0, 3000, keys[:1000])
    # carry the reference's state into a fresh port handle
    carried = repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                      device="cpu")
    if mutability == "ttl":
        carried.load_state(generations=[np.asarray(g) for g in ref.gens.gens],
                           current=ref.gens.current)
    else:
        carried.load_state(np.asarray(ref.state), counts=None if ref.counts
                           is None else ref.counts.counts)
    handles.append(carried)
    _same(ref, carried, qs, lo, hi)
    step(3000, 4000, keys[1000:1500])
    for h in [ref] + handles:
        h.grow(4)
        assert h.spec.n == 12000
    for h in handles:
        _same(ref, h, qs, lo, hi)
    step(4000, 9000, keys[1500:2000])
    live = keys[3000:9000] if mutability == "ttl" else keys[2000:9000]
    for h in handles:
        assert h.point(live).all()


def test_facade_mutability_and_load_state_checks():
    kw = dict(dtype="u32", n=1000)
    plain = repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                    device="cpu")
    with pytest.raises(ValueError, match="deletable"):
        plain.delete([1])
    with pytest.raises(ValueError, match="ttl"):
        plain.advance_generation()
    lanes = np.zeros(plain.layout.total_u32, np.uint32)
    with pytest.raises(ValueError, match="counts"):
        plain.load_state(lanes, counts=np.zeros(plain.layout.total_bits,
                                                np.uint8))
    dele = repro_torch.open_filter(repro_torch.FilterSpec(
        mutability="deletable", **kw), device="cpu")
    with pytest.raises(ValueError, match="counts"):
        dele.load_state(lanes)
    ttl = repro_torch.open_filter(repro_torch.FilterSpec(
        mutability="ttl", generations=2, **kw), device="cpu")
    with pytest.raises(ValueError, match="generations"):
        ttl.load_state(lanes)
    with pytest.raises(ValueError, match="generations"):
        ttl.load_state(generations=[lanes] * 3)
    with pytest.raises(ValueError, match="uint32"):
        ttl.load_state(generations=[lanes, lanes[:-1]])
