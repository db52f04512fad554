"""The port's ``bank`` and ``tenant`` placements (``BankFilter``,
``TenantFilter``) against ``repro``'s on the same ``FilterSpec`` and
seeded keys: states, verdicts, ``range_where_b``, ``observed_fpr`` (whole
bank and per tenant), the ``tenant_bank/*`` obs counters, TTL generations,
``grow`` (in place, and advised under ``tuning="adaptive"``) with
``retune_report``, ``size_bits``, and states carried across both ways.
Last, the façade, bank and prefix-cache paths raise no ``LegacyAPIWarning``
of the port (``pyproject.toml``'s filter matches only ``repro``'s)."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import repro_torch
from repro.obs import metrics as rmetrics
from repro_torch._compat import LegacyAPIWarning
from repro_torch.obs import metrics


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for m in (metrics, rmetrics):
        monkeypatch.setattr(m, "_REGISTRY", m.MetricsRegistry())
        monkeypatch.setattr(m, "_ENABLED", False)


def _pair(**kw):
    return (repro.open_filter(repro.FilterSpec(**kw)),
            repro_torch.open_filter(repro_torch.FilterSpec(**kw),
                                    device="cpu"))


def _data(d, n, q, seed, T=None):
    rng = np.random.default_rng(seed)
    top = (1 << d) - 1
    keys = rng.integers(0, 1 << d, n, dtype=np.uint64)
    lo = np.concatenate([rng.integers(0, 1 << d, q - 3, dtype=np.uint64),
                         np.asarray([0, 0, top], np.uint64)])
    hi = np.minimum(lo + rng.integers(0, 1 << (d // 2), q, dtype=np.uint64),
                    np.uint64(top))
    hi[-3] = top
    pts = np.concatenate([keys[:q // 2], lo[:q - q // 2]])
    if T is None:
        return keys, pts, lo, hi
    ten = rng.integers(0, T, n).astype(np.uint32)
    qten = np.concatenate([ten[:q // 2],
                           rng.integers(0, T, q - q // 2)]).astype(np.uint32)
    return keys, ten, pts, qten, lo, hi


def test_bank_filter_matches_reference():
    ref, port = _pair(dtype="u32", n=2000, placement="bank", shards=4,
                      bits_per_key=14)
    keys, pts, lo, hi = _data(32, 2000, 512, 11)
    for h in (ref, port):
        h.insert(keys)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    wp, wr = ref.point(pts), ref.range(lo, hi)
    np.testing.assert_array_equal(port.point(pts), wp)
    np.testing.assert_array_equal(port.range(lo, hi), wr)
    assert wp[:256].all()
    assert port.size_bits() == ref.size_bits()
    assert port.observed_fpr() == ref.observed_fpr()
    # states carry across both ways
    carried = repro_torch.open_filter(port.spec, device="cpu")
    carried.load_state(np.asarray(ref.state))
    carried.insert(lo[:100])
    ref.state = jnp.asarray(carried.state_numpy())
    np.testing.assert_array_equal(carried.range(lo, hi), ref.range(lo, hi))
    with pytest.raises(ValueError, match="uint32"):
        carried.load_state(np.asarray(ref.state)[:1])
    with pytest.raises(TypeError, match="multiattr"):
        port.range_where_b(1, 2, 3)


def test_multiattr_bank_range_where_b_matches_reference():
    """A d = 64 bank (the plain 64-bit path): both codes of every pair go
    in, and ``B == b AND A in [a_lo, a_hi]`` probes the <B,A> codes."""
    ref, port = _pair(dtype="multiattr", n=500, placement="bank", shards=2)
    rng = np.random.default_rng(12)
    a = rng.integers(0, 1 << 32, 500, dtype=np.uint64)
    b = rng.integers(0, 64, 500, dtype=np.uint64)
    for h in (ref, port):
        h.insert((a, b))
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    bq = np.concatenate([b[:64], rng.integers(64, 128, 64, dtype=np.uint64)])
    alo = np.concatenate([a[:64], a[:64]]) - np.uint64(3)
    ahi = alo + np.uint64(1 << 12)
    got = port.range_where_b(bq, alo, ahi)
    np.testing.assert_array_equal(got, ref.range_where_b(bq, alo, ahi))
    assert got[:64].all()
    assert port.point((a[:50], b[:50])).all()


def test_tenant_filter_with_obs_matches_reference():
    """Obs on: per-tenant reservoirs (at most ``_MAX_FPR_TENANTS``), the
    meta-skip counters of every range chunk, and verdicts with and
    without the meta rows."""
    ref, port = _pair(dtype="u16", n=600, placement="tenant", tenants=2,
                      shards=2, bits_per_key=14)
    keys, ten, pts, qten, lo, hi = _data(16, 1200, 300, 13, T=2)
    repro.obs.enable()
    repro_torch.obs.enable()
    for h in (ref, port):
        h.insert(ten, keys)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    np.testing.assert_array_equal(port.meta_numpy(), np.asarray(ref.meta))
    np.testing.assert_array_equal(port.point(qten, pts), ref.point(qten, pts))
    np.testing.assert_array_equal(port.range(qten, lo, hi),
                                  ref.range(qten, lo, hi))
    # one tenant for the whole batch broadcasts
    np.testing.assert_array_equal(port.point(3, pts), ref.point(3, pts))
    assert sorted(port._fpr_tenants) == [0, 1]
    assert port.observed_fpr() == ref.observed_fpr()
    snap, rsnap = (m.registry().snapshot() for m in (metrics, rmetrics))
    for k in ("tenant_bank/meta_candidates", "tenant_bank/meta_skipped",
              "obs/fpr/tenant/0"):
        assert snap[k] == rsnap[k], k
    assert snap["tenant_bank/meta_skipped"] > 0
    assert port.size_bits() == ref.size_bits()
    with pytest.raises(ValueError, match="align"):
        port.point(np.zeros(3, np.uint32), pts[:4])
    # only the first _MAX_FPR_TENANTS tenants get a reservoir
    many = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u16", n=600, placement="tenant", tenants=10), device="cpu")
    many.insert(np.arange(20) % 10, keys[:20])
    assert len(many._fpr_tenants) == many._MAX_FPR_TENANTS == 8


def test_tenant_filter_ttl_grow_and_states_across_packages():
    ref, port = _pair(dtype="u16", n=400, placement="tenant", tenants=3,
                      mutability="ttl", generations=3)
    keys, ten, pts, qten, lo, hi = _data(16, 900, 256, 14, T=3)
    for step in range(3):
        for h in (ref, port):
            h.insert(ten[step::3], keys[step::3])
            if step < 2:
                h.advance_generation()
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    np.testing.assert_array_equal(port.point(qten, pts), ref.point(qten, pts))
    for h in (ref, port):
        h.grow(2)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    np.testing.assert_array_equal(port.meta_numpy(), np.asarray(ref.meta))
    np.testing.assert_array_equal(port.range(qten, lo, hi),
                                  ref.range(qten, lo, hi))
    assert port.spec.n == ref.spec.n == 800
    # the generations carry across
    carried = repro_torch.open_filter(port.spec, device="cpu")
    carried.load_state(generations=[(np.asarray(s), np.asarray(m))
                                    for s, m in ref.gens.gens],
                       current=ref.gens.current)
    np.testing.assert_array_equal(carried.state_numpy(), port.state_numpy())
    with pytest.raises(ValueError, match="generations"):
        carried.load_state(port.state_numpy(), port.meta_numpy())
    static = repro_torch.open_filter(
        repro_torch.FilterSpec(dtype="u16", n=400, placement="tenant",
                               tenants=3), device="cpu")
    with pytest.raises(ValueError, match="ttl"):
        static.advance_generation()


def test_adaptive_tenant_grow_matches_reference():
    """``tuning="adaptive"``: ``grow()`` takes the factor advised from the
    sampled range workload, with the same ``CostReport``\\ s, and the
    states carry across."""
    ref, port = _pair(dtype="u16", n=500, placement="tenant", tenants=2,
                      tuning="adaptive")
    keys, ten, pts, qten, lo, hi = _data(16, 1000, 256, 15, T=2)
    assert port.retune_report() == ref.retune_report()
    assert port.retune_report()["workload_seen"] == 0
    for h in (ref, port):
        h.insert(ten, keys)
    carried = repro_torch.open_filter(port.spec, device="cpu")
    carried.load_state(np.asarray(ref._state), np.asarray(ref._meta))
    np.testing.assert_array_equal(carried.range(qten, lo, hi),
                                  ref.range(qten, lo, hi))
    port.range(qten, lo, hi)
    for h in (ref, port):
        h.grow()
    assert port.retune_report() == ref.retune_report()
    assert port.retune_report()["promotions"][0]["factor"] in (2, 4, 8)
    np.testing.assert_array_equal(port.state_numpy(), np.asarray(ref.state))
    np.testing.assert_array_equal(port.meta_numpy(), np.asarray(ref.meta))
    np.testing.assert_array_equal(port.point(qten, pts), ref.point(qten, pts))


def test_bank_facade_and_prefix_cache_raise_no_legacy_warning(tmp_path):
    """In-tree construction sites pass ``_warn=False``: the façade's bank
    and tenant handles, their growth, the sharded banks and the prefix
    cache run clean with ``LegacyAPIWarning`` as an error."""
    import torch.distributed as dist

    from repro_torch.dist import ShardedFilterBank
    from repro_torch.serve import PrefixCacheIndex, pack_key
    from repro_torch.store import Store, StoreConfig

    keys = np.arange(0, 60000, 97, dtype=np.uint64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", LegacyAPIWarning)
        b = repro_torch.open_filter(repro_torch.FilterSpec(
            dtype="u16", n=1000, placement="bank", shards=2), device="cpu")
        b.insert(keys)
        assert b.point(keys).all()
        t = repro_torch.open_filter(repro_torch.FilterSpec(
            dtype="u16", n=1000, placement="tenant", tenants=2,
            mutability="ttl"), device="cpu")
        t.insert(1, keys)
        t.grow()
        assert t.range(1, keys, keys + np.uint64(2)).all()
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            ShardedFilterBank(b.bank)
        finally:
            dist.destroy_process_group()
        store = Store(StoreConfig(d=32, memtable_limit=16), device="cpu")
        idx = PrefixCacheIndex(n_tenants=4, backing_store=store,
                               ttl_generations=2, device="cpu")
        idx.freeze_segment({pack_key(s, 1): [s] for s in range(40)})
        assert idx.lookup(7, 1) == [7] and idx.evict_window(0, 9) == 10
