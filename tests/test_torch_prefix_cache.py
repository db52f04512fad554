"""The port's prefix-cache index (``repro_torch.serve.prefix_cache``)
against ``repro.serve.prefix_cache`` on one seeded sequence: every
lookup's pages, ``session_segments``, eviction windows, TTL expiry and the
stats dict, with a durable backing store (WAL) that is reopened through
``reopen_cold_tier``; and the index's routing helpers.  The reference runs
the sequence once per module."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.engine import _filter_for_layout as _rfilter
from repro.serve.prefix_cache import PrefixCacheIndex as RIndex
from repro.store import Store as RStore
from repro.store import StoreConfig as RConfig
from repro_torch.serve import PrefixCacheIndex, pack_key
from repro_torch.store import Store, StoreConfig


def _sequence(index_cls, store_cls, config_cls, wal_dir, **dev):
    """Freeze segments over two TTL windows, look up hits, misses and cold
    entries, sweep windows, expire a window, reopen the cold tier."""
    store = store_cls(config_cls(d=32, memtable_limit=256, level0_runs=2,
                                 durability="wal", wal_dir=str(wal_dir)),
                      **dev)
    idx = index_cls(bits_per_key=14, n_tenants=4, backing_store=store,
                    ttl_generations=2, **dev)
    rng = np.random.default_rng(21)
    out = []
    for seg in range(5):
        ses = rng.choice(400, 12, replace=False)
        idx.freeze_segment({pack_key(int(s), c): [int(s) * 10 + c]
                            for s in ses for c in range(3)})
        if seg == 1:
            out.append(idx.advance_generation())
    cold = next(iter(idx.segments[-1].entries))   # now in the store only
    del idx.segments[-1].entries[cold]
    out.append(idx.lookup(cold >> 16, cold & 0xFFFF))
    for s in rng.choice(ses, 6):
        out.append(idx.lookup(int(s), int(rng.integers(0, 4))))
    for _ in range(30):
        out.append(idx.lookup(int(rng.integers(0, 400)),
                              int(rng.integers(0, 4))))
    out.append([idx.session_segments(s) for s in range(0, 400, 37)])
    out.append(idx.eviction_candidates(100, 180))
    out.append(idx.evict_window(100, 180))
    out.append(idx.advance_generation())
    out.append(idx.advance_generation())
    idx.freeze_segment({pack_key(s, c): [s] for s in range(150, 200, 7)
                        for c in range(5)})    # the other segments' bank
    del idx.segments[-1].entries[pack_key(157, 1)]
    store.checkpoint()
    store.close()
    idx.reopen_cold_tier(str(wal_dir))
    out.append([idx.lookup(s, c) for s in range(143, 200, 7) for c in (0, 1)])
    return out, dict(idx.stats), idx.false_positive_rate()


@functools.lru_cache(maxsize=None)
def _jit_build(layout):
    return jax.jit(_rfilter(layout).build)


class _FastStore(RStore):
    """The reference store with its filter builds under ``jax.jit``, keys
    padded to a power of two by repeating the first (the same bits): one
    compile instead of one per primitive.  The states are the same."""

    def _build_filter(self, layout, keys):
        keys = np.asarray(keys)
        n = 1 << max(int(len(keys) - 1).bit_length(), 4)
        keys = np.concatenate([keys, np.full(n - len(keys), keys[0],
                                             keys.dtype)])
        return _jit_build(layout)(jnp.asarray(keys, self.kdtype))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _sequence(RIndex, _FastStore, RConfig,
                     tmp_path_factory.mktemp("ref_wal"))


def test_prefix_cache_matches_reference(reference, tmp_path):
    got = _sequence(PrefixCacheIndex, Store, StoreConfig, tmp_path / "wal",
                    device="cpu")
    out, stats, fpr = got
    assert got == reference
    # the sequence reaches every counter: hits, cold-tier hits, sweeps,
    # evictions and expiry
    assert all(v > 0 for k, v in stats.items()), stats
    assert [157] in out[-1]            # from the reopened cold tier
    assert fpr == (stats["map_probes"] - stats["map_hits"]) / \
        stats["filter_hits"]


def test_routing_and_validation_match_reference():
    for kw in (dict(n_tenants=3), dict(n_tenants=1 << 16),
               dict(ttl_generations=0)):
        with pytest.raises(ValueError):
            RIndex(**kw)
        with pytest.raises(ValueError):
            PrefixCacheIndex(device="cpu", **kw)
    ref, port = RIndex(n_tenants=8), PrefixCacheIndex(n_tenants=8,
                                                      device="cpu")
    assert port.d_seg == ref.d_seg == 29
    for lo, hi in ((13, 61), (0, 0), (60, 50), (7, 7)):
        for a, b in zip(port._window_probes(lo, hi),
                        ref._window_probes(lo, hi)):
            np.testing.assert_array_equal(a, b)
    assert pack_key(70000, 5) == (70000 & 0xFFFF) << 16 | 5
    with pytest.raises(ValueError, match="domain"):
        port.attach_store(Store(StoreConfig(d=16), device="cpu"))
    with pytest.raises(ValueError, match="ttl_generations"):
        port.advance_generation()
