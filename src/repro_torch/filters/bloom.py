"""Standard Bloom filter (Bloom 1970) — the point-only baseline."""
from __future__ import annotations

import math

import numpy as np

from .api import mix64_np, seeds_np

__all__ = ["BloomFilter"]


class BloomFilter:
    def __init__(self, bits_per_key: float = 10.0, k: int | None = None,
                 seed: int = 0xB10F):
        self.bits_per_key = bits_per_key
        self._k_fixed = k
        self.seed = seed
        self.m = 0
        self.k = 0
        self.bits: np.ndarray | None = None

    def _positions(self, keys: np.ndarray) -> np.ndarray:
        hs = [mix64_np(keys, int(s)) % np.uint64(self.m) for s in self._seeds]
        return np.stack(hs, axis=-1).astype(np.int64)

    def build(self, keys: np.ndarray) -> None:
        n = max(len(keys), 1)
        self.m = max(64, int(n * self.bits_per_key) // 64 * 64)
        # optimal k = ln(2) m/n, floored like RocksDB
        self.k = self._k_fixed or max(1, int(math.log(2) * self.m / n))
        self._seeds = seeds_np(self.seed, self.k)
        self.bits = np.zeros(self.m // 32, np.uint32)
        pos = self._positions(np.asarray(keys, np.uint64)).reshape(-1)
        np.bitwise_or.at(self.bits, pos >> 5,
                         np.uint32(1) << (pos & 31).astype(np.uint32))

    def point(self, qs: np.ndarray) -> np.ndarray:
        pos = self._positions(np.asarray(qs, np.uint64))
        got = (self.bits[pos >> 5] >> (pos & 31).astype(np.uint32)) & 1
        return got.all(axis=-1)

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        raise NotImplementedError("plain Bloom filters cannot answer ranges")

    def size_bits(self) -> int:
        return self.m
