"""Streaming training-data pipeline with bloomRF integration.

Counterpart of ``repro/data/pipeline.py``.  bloomRF is an *online*
point-range filter, so it serves an ingestion loop while documents
arrive:

* :class:`StreamDeduper` -- online dedup over 32-bit document-hash
  sub-domains (the 64-bit hash folded to 32 bits).  A false positive drops
  a unique document (harmless); false negatives are impossible.
* :class:`ShardRangeIndex` -- ZoneMap-style shard admission: each corpus
  shard carries a bloomRF over its document timestamps, and a freshness
  window query ("any docs in [t0, t1]?") skips cold shards unread.
* :func:`batch_iterator` -- packs admitted documents into ``(B, S)`` token
  batches with next-token labels.

The filters run through ``kernels/ops.py``'s ``FilterOps``: on a CUDA
device the insert, point and range kernels, on the CPU their plain
versions.  The states equal the reference's bit for bit (its online
insert sets the same bits as a bulk one).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core import uint64 as u64
from ..core.bloomrf import resolve_device
from ..core.layout import basic_layout
from ..filters.api import mix64_np
from ..kernels.ops import FilterOps

__all__ = ["SyntheticCorpus", "StreamDeduper", "ShardRangeIndex",
           "batch_iterator"]


class SyntheticCorpus:
    """Deterministic zipf-token document stream with duplicates."""

    def __init__(self, vocab: int, seed: int = 0, dup_rate: float = 0.2,
                 mean_len: int = 256, n_shards: int = 8,
                 docs_per_shard: int = 128):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.dup_rate = dup_rate
        self.mean_len = mean_len
        self.n_shards = n_shards
        self.docs_per_shard = docs_per_shard

    def shards(self) -> Iterator[dict]:
        seen_docs: List[np.ndarray] = []
        t = 0
        for s in range(self.n_shards):
            docs, ids, stamps = [], [], []
            for _ in range(self.docs_per_shard):
                t += int(self.rng.integers(1, 20))
                if seen_docs and self.rng.random() < self.dup_rate:
                    tokens = seen_docs[self.rng.integers(len(seen_docs))]
                else:
                    n = max(8, int(self.rng.normal(self.mean_len, 32)))
                    tokens = self.rng.zipf(1.3, n).astype(np.int64) \
                        % self.vocab
                    tokens = tokens.astype(np.int32)
                    seen_docs.append(tokens)
                docs.append(tokens)
                ids.append(int(mix64_np(
                    np.asarray([hash(tokens.tobytes()) & ((1 << 63) - 1)],
                               np.uint64))[0]))
                stamps.append(t)
            yield {"shard": s, "docs": docs,
                   "doc_ids": np.asarray(ids, np.uint64),
                   "timestamps": np.asarray(stamps, np.uint64)}


class StreamDeduper:
    """Online dedup: point-query, then insert the kept ids."""

    def __init__(self, expected_docs: int, bits_per_key: float = 14.0,
                 device=None):
        self.device = resolve_device(device)
        self.layout = basic_layout(32, expected_docs, bits_per_key, delta=6)
        self.ops = FilterOps(self.layout)
        self.state = torch.zeros(self.layout.total_u32, dtype=torch.int32,
                                 device=self.device)
        self.stats = {"seen": 0, "dropped": 0}

    def admit(self, doc_ids: np.ndarray) -> np.ndarray:
        """Returns a keep-mask; inserts the kept ids."""
        ids = np.asarray(doc_ids, np.uint64)
        keys = u64.carrier((ids >> np.uint64(32)) ^ (ids & np.uint64(
            0xFFFFFFFF)), self.device)
        dup = self.ops.point(self.state, keys).cpu().numpy()
        keep = ~dup
        if keep.any():
            kept = keys[torch.from_numpy(keep).to(self.device)]
            self.state = self.ops.insert(self.state, kept.contiguous())
        self.stats["seen"] += len(ids)
        self.stats["dropped"] += int(dup.sum())
        return keep


class ShardRangeIndex:
    """Per-shard bloomRF over timestamps: freshness-window admission."""

    def __init__(self, bits_per_key: float = 12.0, device=None):
        self.device = resolve_device(device)
        self.bits_per_key = bits_per_key
        self.shards: Dict[int, tuple] = {}

    def add_shard(self, shard_id: int, timestamps: np.ndarray) -> None:
        lay = basic_layout(32, max(len(timestamps), 1), self.bits_per_key,
                           delta=6)
        ops = FilterOps(lay)
        st = torch.zeros(lay.total_u32, dtype=torch.int32,
                         device=self.device)
        self.shards[shard_id] = (ops, ops.insert(st, u64.carrier(
            timestamps, self.device)))

    def shards_in_window(self, t0: int, t1: int) -> List[int]:
        lo = u64.carrier([t0], self.device)
        hi = u64.carrier([t1], self.device)
        return [sid for sid, (ops, st) in self.shards.items()
                if bool(ops.range(st, lo, hi)[0])]


def batch_iterator(corpus: SyntheticCorpus, batch: int, seq: int,
                   deduper: Optional[StreamDeduper] = None,
                   window: Optional[tuple] = None,
                   device=None) -> Iterator[dict]:
    """Pack admitted documents into ``(B, S)`` token/label batches (int32
    tensors on ``device``), forever."""
    device = resolve_device(device)
    index = ShardRangeIndex(device=device)
    shard_list = list(corpus.shards())
    for sh in shard_list:
        index.add_shard(sh["shard"], sh["timestamps"])
    admitted = (set(index.shards_in_window(*window)) if window is not None
                else {sh["shard"] for sh in shard_list})
    stream: List[np.ndarray] = []
    while True:
        for sh in shard_list:
            if sh["shard"] not in admitted:
                continue
            keep = (deduper.admit(sh["doc_ids"]) if deduper is not None
                    else np.ones(len(sh["docs"]), bool))
            for d, k in zip(sh["docs"], keep):
                if k:
                    stream.append(d)
            while sum(len(d) for d in stream) >= batch * (seq + 1):
                flat = np.concatenate(stream)
                take = batch * (seq + 1)
                chunk = flat[:take].reshape(batch, seq + 1)
                rest = flat[take:]
                stream = [rest] if len(rest) else []
                yield {"tokens": torch.from_numpy(
                           np.ascontiguousarray(chunk[:, :-1])).to(device),
                       "labels": torch.from_numpy(
                           np.ascontiguousarray(chunk[:, 1:])).to(device)}
