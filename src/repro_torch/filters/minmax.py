"""Fence pointers / ZoneMap / BRIN-style min-max blocks.

Keys are sorted and chunked into blocks of B keys; each block stores
(min, max).  A range query is positive iff it overlaps any block interval;
point queries likewise (with block-level granularity).  128 bits per block
=> bits/key = 128 / B.
"""
from __future__ import annotations

import numpy as np

__all__ = ["FencePointers"]


class FencePointers:
    def __init__(self, bits_per_key: float = 10.0):
        self.bits_per_key = bits_per_key

    def build(self, keys: np.ndarray) -> None:
        ks = np.sort(np.asarray(keys, np.uint64))
        B = max(1, int(np.ceil(128.0 / self.bits_per_key)))
        nb = (len(ks) + B - 1) // B
        self.mins = ks[::B][:nb].copy()
        self.maxs = np.asarray(
            [ks[min((i + 1) * B, len(ks)) - 1] for i in range(nb)], np.uint64)
        self._nblocks = nb

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        lo = np.asarray(lo, np.uint64)
        hi = np.asarray(hi, np.uint64)
        # overlap iff exists block with min <= hi and max >= lo
        i = np.searchsorted(self.mins, hi, side="right") - 1
        # the candidate block is the last with min <= hi; also check next-left
        ok = np.zeros(len(lo), bool)
        valid = i >= 0
        ok[valid] = self.maxs[np.maximum(i[valid], 0)] >= lo[valid]
        return ok

    def point(self, qs: np.ndarray) -> np.ndarray:
        qs = np.asarray(qs, np.uint64)
        return self.range(qs, qs)

    def size_bits(self) -> int:
        return int(self._nblocks * 128)
