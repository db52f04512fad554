"""The port's façade against ``repro``'s: the same ``FilterSpec`` and keys
give the same state and verdicts, for every placement; states carry across
in both directions."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from conftest import brute_force_range_truth
from repro_torch.core import BloomRF, FilterLayout, basic_layout


def _keys_and_queries(dtype, rng, n, q):
    if dtype == "f32":
        keys = rng.normal(0, 100, n).astype(np.float32)
        lo = rng.normal(0, 100, q).astype(np.float32)
        hi = lo + rng.exponential(0.5, q).astype(np.float32)
        return keys, lo, hi
    d = int(dtype[1:])
    keys = rng.integers(0, 1 << d, n, dtype=np.uint64)
    lo = rng.integers(0, 1 << d, q, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << min(d - 2, 10), q,
                                      dtype=np.uint64), (1 << d) - 1)
    return keys, lo, hi


@pytest.mark.parametrize("tuning", ["basic", "advised"])
@pytest.mark.parametrize("dtype", ["u16", "u32", "f32"])
def test_open_filter_matches_reference(dtype, tuning):
    rng = np.random.default_rng(0xFACE)
    kw = dict(dtype=dtype, n=3000, tuning=tuning, range_log2=10)
    ref = repro.open_filter(repro.FilterSpec(backend="xla", **kw))
    port = repro_torch.open_filter(repro_torch.FilterSpec(**kw), device="cpu")
    kern = repro_torch.open_filter(
        repro_torch.FilterSpec(backend="resident", **kw), device="cpu")
    assert port.layout == FilterLayout.from_dict(
        dataclasses.asdict(ref.layout))
    assert port.backend == "xla" and port.tuning == ref.tuning
    keys, lo, hi = _keys_and_queries(dtype, rng, 3000, 2048)
    for h in (ref, port, kern):
        h.insert(keys)
    want_state = np.asarray(ref.state)
    np.testing.assert_array_equal(port.state_numpy(), want_state)
    np.testing.assert_array_equal(kern.state_numpy(), want_state)
    want = ref.range(lo, hi)
    np.testing.assert_array_equal(port.range(lo, hi), want)
    np.testing.assert_array_equal(kern.range(lo, hi), want)
    qs = np.concatenate([keys[:1000], lo[:1048]])
    wp = ref.point(qs)
    np.testing.assert_array_equal(port.point(qs), wp)
    np.testing.assert_array_equal(kern.point(qs), wp)
    assert wp[:1000].all()
    if dtype != "f32":
        truth = brute_force_range_truth(keys, lo, hi)
        assert not (truth & ~want).any()
    # states carry across both ways: a ``repro`` state loaded into the port,
    # and the port's state (after more keys) loaded into ``repro``
    carried = repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                      device="cpu")
    carried.load_state(np.asarray(ref.state))
    np.testing.assert_array_equal(carried.range(lo, hi), want)
    carried.insert(keys[::-1][:500] if dtype == "f32" else lo[:500])
    ref.state = jnp.asarray(carried.state_numpy())
    np.testing.assert_array_equal(ref.range(lo, hi), carried.range(lo, hi))
    np.testing.assert_array_equal(ref.point(qs), carried.point(qs))
    with pytest.raises(ValueError, match="uint32"):
        carried.load_state(np.asarray(ref.state).astype(np.int64))


def test_default_device_without_card_raises(monkeypatch):
    """No entry point quietly picks the CPU: without a card the default
    device raises, and ``device="cpu"`` is the explicit way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32", n=100))
    lay = basic_layout(32, 100, 16.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BloomRF(lay)
    assert BloomRF(lay, device="cpu").init_state().device.type == "cpu"


@pytest.mark.parametrize("kw,item", [
    (dict(dtype="u32", placement="bank", shards=2), "A.9"),
    (dict(dtype="u32", placement="tenant", tenants=2), "A.9"),
    (dict(dtype="f64", placement="tenant", tenants=2), "A.9"),
    (dict(dtype="u32", placement="tenant", tenants=2, tuning="adaptive"),
     "A.9"),
])
def test_not_ported_raises(kw, item):
    """The bank and tenant placements (ROADMAP ``item``; they raised
    ``NotImplementedError`` before it was ported) open on the CPU and
    answer as ``repro`` does on the same spec: state and verdicts."""
    spec = dict(n=1000, **kw)
    ref = repro.open_filter(repro.FilterSpec(**spec))
    port = repro_torch.open_filter(repro_torch.FilterSpec(**spec),
                                   device="cpu")
    rng = np.random.default_rng(0xA9)
    if kw["dtype"] == "f64":
        keys = rng.normal(0, 1e6, 500)
        lo = rng.normal(0, 1e6, 256)
        hi = lo + rng.exponential(1e3, 256)
    else:
        keys, lo, hi = _keys_and_queries("u32", rng, 500, 256)
    if kw["placement"] == "bank":
        for h in (ref, port):
            h.insert(keys)
        args, pargs = (lo, hi), (keys,)
    else:
        ten = rng.integers(0, 2, 500).astype(np.uint32)
        for h in (ref, port):
            h.insert(ten, keys)
        np.testing.assert_array_equal(port.meta_numpy(),
                                      np.asarray(ref.meta))
        args, pargs = (ten[:256], lo, hi), (ten, keys)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    assert port.point(*pargs).all()
    np.testing.assert_array_equal(port.range(*args), ref.range(*args))


def test_not_ported_methods_raise():
    """``observed_fpr`` is ported (it raised naming A.7 before) and answers
    on an empty filter; ``range_where_b`` is ported and, as in the
    reference, refuses keys that are not multiattr."""
    h = repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32", n=100),
                                device="cpu")
    out = h.observed_fpr()
    assert out["point_fpr"] == 0.0 and out["point_candidates"] == 512
    with pytest.raises(TypeError, match="multiattr"):
        h.range_where_b(1, 2, 3)


def test_partitioned_backend_opens_and_answers():
    """``backend="partitioned"`` is ported (it raised naming B.7 before):
    the handle takes the partitioned tier and answers like ``auto``."""
    rng = np.random.default_rng(0xB7)
    keys = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    part, auto = (repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", n=1000, backend=b), device="cpu")
        for b in ("partitioned", "auto"))
    assert not part.ops.resident
    for h in (part, auto):
        h.insert(keys)
    np.testing.assert_array_equal(part.state_numpy(), auto.state_numpy())
    assert part.point(keys).all() and part.range(keys, keys + 3).all()


@pytest.mark.parametrize("mutability", ["deletable", "ttl"])
def test_single_mutable_filters_open(mutability):
    """``mutability="deletable"`` (it raised naming A.2 before) and
    ``"ttl"`` open a single filter whose delete / advance_generation and
    grow work; tests/test_torch_dynamic.py holds them to ``repro``."""
    rng = np.random.default_rng(0xA2)
    keys = rng.integers(0, 1 << 32, 1000, dtype=np.uint64)
    h = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", n=1000, mutability=mutability, generations=2),
        device="cpu")
    h.insert(keys)
    if mutability == "deletable":
        h.delete(keys[:500])
        assert h.point(keys[:500]).mean() < 0.1
    else:
        h.advance_generation()
        h.advance_generation()
        assert not h.state_numpy().any()
        h.insert(keys[500:])
    h.grow(4)
    assert h.point(keys[500:]).all()


def test_spec_validation_matches_reference():
    for kw in (dict(dtype="u99"), dict(n=0), dict(backend="stacked"),
               dict(bits_per_key=4.0, target_fpr=0.1), dict(dtype="u16",
                                                             range_log2=17)):
        with pytest.raises(ValueError):
            repro.FilterSpec(**kw)
        with pytest.raises(ValueError):
            repro_torch.FilterSpec(**kw)
    for kw in (dict(dtype="u32", target_fpr=0.05, range_log2=4),
               dict(dtype="f32", n=10)):
        assert repro_torch.FilterSpec(**kw).resolved_bits_per_key() == \
            repro.FilterSpec(**kw).resolved_bits_per_key()
