"""bloomRF-indexed prefix-KV-cache admission, backed by the multi-tenant
filter bank.

Counterpart of ``repro/serve/prefix_cache.py``.  Frozen cache *segments*
are the analogue of SST files: immutable maps from ``(session,
chunk_position)`` keys to lists of KV page ids.  Each segment carries a
:class:`~repro_torch.dist.tenant_bank.TenantFilterBank` where every
**session namespace is a tenant**: the low ``log2(n_tenants)`` bits of the
session id pick the tenant row, and the remaining session bits with the
chunk position form the tenant-local key ``(session >> nt) << 16 |
chunk``.  A lookup consults the cheap per-tenant filters before touching
any segment's map:

* point query -- "is this exact (session, chunk) prefix cached?";
* range query -- "does this segment hold ANY chunk for session s?" (a
  session's chunks are one contiguous tenant-local range), and "any
  activity in a session-id window?" for eviction sweeps: the window
  decomposes into one contiguous local range per tenant because sessions
  stripe over tenants by their low bits.  Ranges AND in the segment's
  meta rows (built over the session prefixes, chunk bits dropped).

Every segment is consulted in one call per bank (capacity class): a
bank's segments have one shard, and each tenant's rows of them are stacked
once, when the list of segments changes, so a lookup of tenant ``t`` is
one stacked point-kernel launch over ``t``'s rows on the card (B6) and a
range query one plain ``StackedProbe`` call over them and their meta rows,
whatever the number of segments.  The answers and
the ``stats`` counters are those of the reference's segment-by-segment
walk, newest first: the walk reads the verdicts of that one call.

Keys stay in a 32-bit domain (16-bit session, 16-bit chunk), so the
filters take the kernels.  Filters never give false negatives, so no
cached prefix is missed; a false positive costs one extra map probe
(counted in ``stats``).

Optionally the index is backed by an LSM :class:`~repro_torch.store.Store`
(``backing_store=``): frozen entries are mirrored into the store as the
cold tier, total-miss lookups fall through to ``store.get``, and
:meth:`PrefixCacheIndex.evict_window` sweeps a session-id window through
one ``store.scan`` (the store-scan kernel prunes its runs on the card) and
one batched ``delete_many``.  The index's filters live on ``device``
(default ``"cuda"``).
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import codecs
from ..core.bloomrf import resolve_device
from ..core.hashing import dyadic_prefixes
from ..dist.filter_bank import point_rows, range_rows
from ..dist.tenant_bank import TenantFilterBank
from ..obs import metrics as _obs_metrics
from ..store import Store

__all__ = ["PrefixCacheIndex", "pack_key"]

_CHUNK_BITS = 16
_SES_BITS = 16


def pack_key(session: int, chunk: int) -> int:
    """(session, chunk) -> packed key via the order-preserving two-attribute
    codec (``core.codecs.pack2``) with a 16-bit low field."""
    return int(codecs.pack2(session & 0xFFFF, chunk & 0xFFFF, _CHUNK_BITS))


def _ids(a, device) -> torch.Tensor:
    """uint32 ids or keys as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


class _Segment:
    def __init__(self, entries: Dict[int, List[int]], bank: TenantFilterBank,
                 tenants: np.ndarray, local_keys: np.ndarray, gen: int = 0):
        self.entries = entries
        self.bank = bank
        self.gen = gen               # generation the segment was frozen in
        self.state, self.meta = bank.build(_ids(tenants, bank.device),
                                           _ids(local_keys, bank.device))


class _Group:
    """The segments of one single-shard bank, each tenant's rows of them
    stacked once: ``flat[t]`` holds tenant ``t``'s main rows of every
    segment (row ``j`` is segment ``idx[j]``), then its meta rows, the
    layout of the bank's ``row_probes(n)``."""

    def __init__(self, bank: TenantFilterBank, idx: List[int],
                 segments: List[_Segment]):
        self.bank = bank
        self.idx = idx
        n = len(idx)
        main = torch.stack([segments[i].state[:, 0] for i in idx], dim=1)
        meta = torch.stack([segments[i].meta[:, 0] for i in idx], dim=1)
        self.flat = torch.cat([main.reshape(bank.n_tenants, -1),
                               meta.reshape(bank.n_tenants, -1)], dim=1)
        self.probe, self.probe_meta, _ = bank.row_probes(n)

    def point(self, tenant: int, key: torch.Tensor) -> np.ndarray:
        """Each segment's verdict for one key: one call over its ``n``
        rows (B6 on the card)."""
        bank, n = self.bank, len(self.idx)
        lay = bank.bank.layout
        rows = self.flat[tenant, :n * lay.total_u32].view(n, -1)
        return point_rows(lay, rows, key, self.probe,
                          bank.kernels)[0].cpu().numpy()

    def range(self, tenant: int, lo: torch.Tensor,
              hi: torch.Tensor) -> np.ndarray:
        """Each segment's main AND meta verdict for one range: one plain
        stacked call over its ``2n`` rows."""
        bank, n = self.bank, len(self.idx)

        def bounds(x):
            pre = dyadic_prefixes(x, bank.meta_level, bank.bank.d_local)
            return torch.cat([x.expand(n), pre.expand(n)])[None]

        hits = range_rows(self.probe_meta, self.flat[tenant], bounds(lo),
                          bounds(hi))[0]
        return (hits[:n] & hits[n:]).cpu().numpy()


class PrefixCacheIndex:
    def __init__(self, bits_per_key: float = 14.0, n_tenants: int = 16,
                 backing_store: Optional[Store] = None,
                 ttl_generations: Optional[int] = None, device=None):
        if n_tenants < 1 or n_tenants & (n_tenants - 1):
            raise ValueError(
                f"n_tenants must be a power of two, got {n_tenants}")
        if n_tenants > (1 << (_SES_BITS - 1)):
            # at least one session bit must remain for the tenant-local key
            raise ValueError(f"at most {1 << (_SES_BITS - 1)} tenants")
        if ttl_generations is not None and ttl_generations < 1:
            raise ValueError(
                f"ttl_generations must be >= 1, got {ttl_generations}")
        self.device = resolve_device(device)
        self.bits_per_key = bits_per_key
        self.n_tenants = n_tenants
        self.nt_bits = n_tenants.bit_length() - 1
        self.d_seg = (_SES_BITS - self.nt_bits) + _CHUNK_BITS
        self.segments: List[_Segment] = []
        self._banks: Dict[int, TenantFilterBank] = {}
        self._group_cache: Optional[List[_Group]] = None
        self.ttl_generations = ttl_generations
        self.generation = 0
        self.stats = {"filter_probes": 0, "filter_hits": 0,
                      "map_probes": 0, "map_hits": 0, "range_probes": 0,
                      "store_probes": 0, "store_hits": 0, "evicted": 0,
                      "expired": 0}
        self.store: Optional[Store] = None
        if backing_store is not None:
            self.attach_store(backing_store)
        if _obs_metrics.enabled():
            self.register_obs()

    def register_obs(self, family: str = "prefix_cache") -> str:
        """Publish the admission stats (and the live fp_rate) as a metric
        family, through a weak reference: a collected index's family
        reports ``None`` and is pruned at the next registry snapshot."""
        ref = weakref.ref(self)

        def _family():
            idx = ref()
            if idx is None:
                return None
            out = dict(idx.stats)
            out["fp_rate"] = idx.false_positive_rate()
            return out

        return _obs_metrics.registry().register_family(family, _family)

    def attach_store(self, store: Store, backfill: bool = True) -> None:
        """Use an LSM run-store as the cold tier behind the segments.

        Segments frozen before attachment are backfilled (``backfill=True``),
        so the cold tier mirrors every frozen entry; pass ``backfill=False``
        when the store already holds them (:meth:`reopen_cold_tier`)."""
        if store.cfg.d < _SES_BITS + _CHUNK_BITS:
            raise ValueError(
                f"backing store needs a >= {_SES_BITS + _CHUNK_BITS}-bit "
                f"domain for packed keys, got d={store.cfg.d}")
        self.store = store
        if backfill:
            for seg in self.segments:
                for k, pages in seg.entries.items():
                    store.put(k, pages)

    def reopen_cold_tier(self, wal_dir: str, config=None) -> Store:
        """Recover a durable cold tier from ``wal_dir`` (``Store.open`` on
        the index's device: CRCs verified, torn WAL tail healed,
        acknowledged writes and eviction tombstones replayed) and attach it
        without backfill; returns the store."""
        store = Store.open(wal_dir, config=config, device=self.device)
        self.attach_store(store, backfill=False)
        return store

    # -- session-namespace routing (scalar ints and numpy arrays alike) --
    def _tenant(self, session):
        return session & (self.n_tenants - 1)

    def _local_key(self, session, chunk):
        local_ses = (session & 0xFFFF) >> self.nt_bits
        return codecs.pack2(local_ses, chunk, _CHUNK_BITS)

    def _bank_for(self, n_entries: int) -> TenantFilterBank:
        """Banks are cached per capacity class (a power of two), so
        segments of similar size share one bank and its stacked probes."""
        cap = max(16, 1 << (max(n_entries, 1) - 1).bit_length())
        if cap not in self._banks:
            self._banks[cap] = TenantFilterBank(
                self.d_seg, self.n_tenants, 1,
                n_keys_per_tenant=max(cap // self.n_tenants, 1),
                bits_per_key=self.bits_per_key, delta=6,
                meta_level=_CHUNK_BITS, device=self.device, _warn=False)
        return self._banks[cap]

    def _groups(self) -> List[_Group]:
        """The segments grouped by bank, stacked; rebuilt after the list of
        segments changed (a segment's filters never change)."""
        if self._group_cache is None:
            by_bank: Dict[int, tuple] = {}
            for i, seg in enumerate(self.segments):
                by_bank.setdefault(id(seg.bank), (seg.bank, []))[1].append(i)
            self._group_cache = [_Group(bank, idx, self.segments)
                                 for bank, idx in by_bank.values()]
        return self._group_cache

    def _verdicts(self, probe) -> np.ndarray:
        """``probe(group)``'s verdicts, one per segment, in segment order."""
        out = np.zeros(len(self.segments), bool)
        for g in self._groups():
            out[g.idx] = probe(g)
        return out

    # ------------------------------------------------------------------
    def freeze_segment(self, entries: Dict[int, List[int]]) -> int:
        """Freeze a batch of (packed key -> page list) into a new segment."""
        entries = dict(entries)
        packed = list(entries) or [pack_key(0, 0)]
        sessions = np.asarray([k >> _CHUNK_BITS for k in packed], np.uint32)
        chunks = np.asarray([k & 0xFFFF for k in packed], np.uint32)
        tenants = self._tenant(sessions).astype(np.uint32)
        local = self._local_key(sessions, chunks).astype(np.uint32)
        self.segments.append(_Segment(entries, self._bank_for(len(packed)),
                                      tenants, local, gen=self.generation))
        self._group_cache = None
        if self.store is not None:           # mirror into the cold tier
            for k, pages in entries.items():
                self.store.put(k, pages)
        return len(self.segments) - 1

    def lookup(self, session: int, chunk: int) -> Optional[List[int]]:
        """Newest-first point lookup through the per-tenant filters."""
        key = pack_key(session, chunk)
        t = self._tenant(session)
        q = _ids([self._local_key(session, chunk)], self.device)
        hits = self._verdicts(lambda g: g.point(t, q))
        for i in reversed(range(len(self.segments))):
            seg = self.segments[i]
            self.stats["filter_probes"] += 1
            if hits[i]:
                self.stats["filter_hits"] += 1
                self.stats["map_probes"] += 1
                if key in seg.entries:
                    self.stats["map_hits"] += 1
                    return seg.entries[key]
        if self.store is not None:           # cold tier (evictions masked
            self.stats["store_probes"] += 1  # there by tombstones)
            pages = self.store.get(key)
            if pages is not None:
                self.stats["store_hits"] += 1
                return pages
        return None

    def session_segments(self, session: int) -> List[int]:
        """Range query: segments possibly holding ANY chunk of ``session``."""
        t = self._tenant(session)
        lo = _ids([self._local_key(session, 0)], self.device)
        hi = _ids([self._local_key(session, (1 << _CHUNK_BITS) - 1)],
                  self.device)
        return self._count_ranges(self._verdicts(lambda g: g.range(t, lo,
                                                                    hi)))

    def _count_ranges(self, hits: np.ndarray) -> List[int]:
        """The segments a range query found, one range probe counted a
        segment."""
        self.stats["filter_probes"] += len(hits)
        self.stats["range_probes"] += len(hits)
        return [int(i) for i in np.flatnonzero(hits)]

    def _window_probes(self, lo_session: int,
                       hi_session: int) -> Tuple[np.ndarray, ...]:
        """Decompose a session-id window into per-tenant local key ranges:
        the sessions of tenant ``t`` inside the window are one contiguous
        local-session interval, each one (tenant, lo, hi) probe."""
        T = self.n_tenants
        ts, los, his = [], [], []
        for t in range(T):
            lo_loc = (max(lo_session - t, 0) + T - 1) // T
            if hi_session < t:
                continue
            hi_loc = (hi_session - t) // T
            if hi_loc < lo_loc:
                continue
            ts.append(t)
            los.append(lo_loc << _CHUNK_BITS)
            his.append((hi_loc << _CHUNK_BITS) | ((1 << _CHUNK_BITS) - 1))
        return (np.asarray(ts, np.uint32), np.asarray(los, np.uint32),
                np.asarray(his, np.uint32))

    def eviction_candidates(self, lo_session: int,
                            hi_session: int) -> List[int]:
        """Range sweep over a session-id window (e.g. an expired id range)."""
        ts, los, his = self._window_probes(lo_session, hi_session)
        if not len(ts):
            return []
        lo, hi = _ids(los, self.device), _ids(his, self.device)
        hits = np.zeros(len(self.segments), bool)
        for p, t in enumerate(ts.tolist()):
            hits |= self._verdicts(lambda g: g.range(t, lo[p:p + 1],
                                                     hi[p:p + 1]))
        return self._count_ranges(hits)

    def evict_window(self, lo_session: int, hi_session: int) -> int:
        """Evict every cached prefix whose session id is in the window.

        The range filters narrow the sweep to candidate segments, whose
        matching entries are dropped from their maps.  With a backing
        store the cold tier is swept too: the window is one contiguous
        range of packed keys, so one ``store.scan`` finds every cold entry,
        and the tombstones go in as ONE batched ``store.delete_many`` after
        the scan (a per-key delete loop could flush and compact
        mid-sweep).  Segment filters are insert-only, so an evicted key
        costs one filter false positive until its segment retires."""
        dropped = set()
        for i in self.eviction_candidates(lo_session, hi_session):
            seg = self.segments[i]
            drop = [k for k in seg.entries
                    if lo_session <= (k >> _CHUNK_BITS) <= hi_session]
            for k in drop:
                del seg.entries[k]
            dropped.update(drop)
        if self.store is not None:
            chunk_full = (1 << _CHUNK_BITS) - 1
            cold = [k for k, _ in self.store.scan(
                lo_session << _CHUNK_BITS,
                (hi_session << _CHUNK_BITS) | chunk_full)]
            self.store.delete_many(cold)
            dropped.update(cold)
        self.stats["evicted"] += len(dropped)
        return len(dropped)

    def advance_generation(self) -> int:
        """Close the current TTL window: segments frozen more than
        ``ttl_generations`` windows ago retire wholesale (entries, filter
        state and bits together), their entries batch-tombstoned in the
        cold tier.  Returns the number of entries expired."""
        if self.ttl_generations is None:
            raise ValueError(
                "PrefixCacheIndex was built without ttl_generations")
        self.generation += 1
        cutoff = self.generation - self.ttl_generations
        expired: List[int] = []
        kept: List[_Segment] = []
        for seg in self.segments:
            if seg.gen <= cutoff:
                expired.extend(seg.entries)
            else:
                kept.append(seg)
        self.segments = kept
        self._group_cache = None
        if self.store is not None and expired:
            self.store.delete_many(expired)
        self.stats["expired"] += len(expired)
        return len(expired)

    def false_positive_rate(self) -> float:
        fp = self.stats["map_probes"] - self.stats["map_hits"]
        return fp / max(self.stats["filter_hits"], 1)
