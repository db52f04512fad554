"""Cuckoo filter (Fan et al., CoNEXT 2014): partial-key cuckoo hashing,
4-slot buckets.  Point queries only (the paper compares it in Fig. 12.E)."""
from __future__ import annotations

import numpy as np

from .api import mix64_np

__all__ = ["CuckooFilter"]


class CuckooFilter:
    def __init__(self, fingerprint_bits: int = 12, occupancy: float = 0.95,
                 max_kicks: int = 500, seed: int = 0xC0C0):
        self.f = fingerprint_bits
        self.occupancy = occupancy
        self.max_kicks = max_kicks
        self.seed = seed

    def _fingerprint(self, keys: np.ndarray) -> np.ndarray:
        fp = mix64_np(keys, self.seed + 1) & np.uint64((1 << self.f) - 1)
        return np.where(fp == 0, np.uint64(1), fp)  # 0 marks empty slots

    def _i1(self, keys: np.ndarray) -> np.ndarray:
        return (mix64_np(keys, self.seed) & np.uint64(self.nb - 1)).astype(np.int64)

    def _alt(self, i: np.ndarray, fp: np.ndarray) -> np.ndarray:
        return (np.asarray(i, np.uint64) ^
                (mix64_np(fp, self.seed + 2) & np.uint64(self.nb - 1))
                ).astype(np.int64)

    def build(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        n = max(len(keys), 1)
        nb = 1
        while nb * 4 * self.occupancy < n:
            nb <<= 1
        self.nb = nb
        self.table = np.zeros((nb, 4), np.uint64)
        self.stash: list = []
        fps = self._fingerprint(keys)
        i1s = self._i1(keys)
        rng = np.random.default_rng(self.seed)
        for fp, i1 in zip(fps.tolist(), i1s.tolist()):
            fp = np.uint64(fp)
            placed = False
            for idx in (i1, int(self._alt(np.asarray([i1]), np.asarray([fp]))[0])):
                row = self.table[idx]
                free = np.nonzero(row == 0)[0]
                if len(free):
                    row[free[0]] = fp
                    placed = True
                    break
            if placed:
                continue
            idx = i1
            cur = fp
            for _ in range(self.max_kicks):
                slot = rng.integers(0, 4)
                cur, self.table[idx, slot] = self.table[idx, slot], cur
                idx = int(self._alt(np.asarray([idx]),
                                    np.asarray([cur], np.uint64))[0])
                row = self.table[idx]
                free = np.nonzero(row == 0)[0]
                if len(free):
                    row[free[0]] = cur
                    cur = None
                    break
            if cur is not None:
                self.stash.append(np.uint64(cur))

    def point(self, qs: np.ndarray) -> np.ndarray:
        qs = np.asarray(qs, np.uint64)
        fp = self._fingerprint(qs)
        i1 = self._i1(qs)
        i2 = self._alt(i1, fp)
        hit = (self.table[i1] == fp[:, None]).any(axis=1)
        hit |= (self.table[i2] == fp[:, None]).any(axis=1)
        if self.stash:
            hit |= np.isin(fp, np.asarray(self.stash, np.uint64))
        return hit

    def range(self, lo, hi):
        raise NotImplementedError("cuckoo filters cannot answer ranges")

    def size_bits(self) -> int:
        return int(self.nb * 4 * self.f + 64 * len(self.stash))
