"""Prefix Bloom filter: a BF over fixed-level key prefixes.

Classic range-capable baseline (the paper's "Prefix-BF"): ranges are answered
by probing every covering prefix at the configured level; point lookups probe
the key's own prefix (hence elevated point FPR — all keys sharing a prefix are
indistinguishable)."""
from __future__ import annotations

import math

import numpy as np

from .api import mix64_np, seeds_np

__all__ = ["PrefixBloomFilter"]


class PrefixBloomFilter:
    def __init__(self, bits_per_key: float = 10.0, prefix_level: int = 12,
                 max_probe: int = 4096, seed: int = 0x9F1B):
        self.bits_per_key = bits_per_key
        self.level = prefix_level
        self.max_probe = max_probe
        self.seed = seed

    def build(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, np.uint64)
        prefixes = keys >> np.uint64(self.level)
        n = max(len(keys), 1)
        self.m = max(64, int(n * self.bits_per_key) // 64 * 64)
        self.k = max(1, int(math.log(2) * self.m / n))
        self._seeds = seeds_np(self.seed, self.k)
        self.bits = np.zeros(self.m // 32, np.uint32)
        pos = self._positions(prefixes).reshape(-1)
        np.bitwise_or.at(self.bits, pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))

    def _positions(self, prefixes: np.ndarray) -> np.ndarray:
        hs = [mix64_np(prefixes, int(s)) % np.uint64(self.m) for s in self._seeds]
        return np.stack(hs, axis=-1).astype(np.int64)

    def _probe(self, prefixes: np.ndarray) -> np.ndarray:
        pos = self._positions(prefixes)
        got = (self.bits[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1
        return got.all(axis=-1)

    def point(self, qs: np.ndarray) -> np.ndarray:
        return self._probe(np.asarray(qs, np.uint64) >> np.uint64(self.level))

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        lo = np.asarray(lo, np.uint64) >> np.uint64(self.level)
        hi = np.asarray(hi, np.uint64) >> np.uint64(self.level)
        span = (hi - lo + np.uint64(1)).astype(np.int64)
        out = np.zeros(len(lo), bool)
        over = span > self.max_probe
        out[over] = True  # conservatively positive beyond the probe budget
        todo = np.nonzero(~over)[0]
        # probe prefix-by-prefix, vectorized over queries still pending
        step = np.zeros(len(lo), np.uint64)
        pending = todo
        while len(pending):
            p = lo[pending] + step[pending]
            hit = self._probe(p)
            out[pending[hit]] = True
            step[pending] += np.uint64(1)
            keep = (~hit) & (lo[pending] + step[pending] <= hi[pending])
            pending = pending[keep]
        return out

    def size_bits(self) -> int:
        return self.m
