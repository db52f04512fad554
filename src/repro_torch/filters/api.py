"""Common point-range-filter API + shared host-side hashing."""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

__all__ = ["PointRangeFilter", "mix64_np", "seeds_np"]

_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def mix64_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """splitmix64 finalizer (vectorized numpy, wrapping uint64)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint64) ^ np.uint64(seed)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def seeds_np(base: int, n: int) -> np.ndarray:
    """n derived seeds: splitmix64 over the golden-gamma sequence from
    ``base`` (vectorized; identical values to the historical scalar loop)."""
    with np.errstate(over="ignore"):
        steps = np.uint64(base) + (np.uint64(0x9E3779B97F4A7C15)
                                   * np.arange(1, n + 1, dtype=np.uint64))
    return mix64_np(steps)


@runtime_checkable
class PointRangeFilter(Protocol):
    """Build-once, query-many filter facade used by the benchmark harness."""

    def build(self, keys: np.ndarray) -> None: ...

    def point(self, qs: np.ndarray) -> np.ndarray: ...

    def range(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray: ...

    def size_bits(self) -> int: ...
