"""Mutable write buffer of the LSM store.

A copy of ``repro/store/memtable.py`` (plain Python and numpy); the port
keeps its own so that it never imports the JAX package.

A plain insertion dict: ``put`` overwrites, ``delete`` writes the
:data:`TOMBSTONE` sentinel (deletes must flush as explicit markers so they
mask older runs — the filters are insert-only, so a key's *absence* can
never be encoded, only an entry saying "deleted here").  ``sorted_entries``
is the flush view: keys ascending, one entry per key (last write wins).
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

__all__ = ["Memtable", "TOMBSTONE"]


class _Tombstone:
    """Sentinel marking a deleted key (distinct from any stored value)."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<tombstone>"


TOMBSTONE = _Tombstone()


class Memtable:
    def __init__(self) -> None:
        self._map: dict = {}

    def __len__(self) -> int:
        return len(self._map)

    def put(self, key: int, value) -> None:
        self._map[int(key)] = value

    def delete(self, key: int) -> None:
        self._map[int(key)] = TOMBSTONE

    def get(self, key: int) -> Tuple[bool, object]:
        """(present-in-memtable, value-or-TOMBSTONE)."""
        k = int(key)
        if k in self._map:
            return True, self._map[k]
        return False, None

    def items(self) -> Iterator[Tuple[int, object]]:
        return iter(self._map.items())

    def sorted_entries(self) -> Tuple[np.ndarray, list, np.ndarray]:
        """Flush view: (sorted uint64 keys, values, tombstone mask)."""
        ks = sorted(self._map)
        keys = np.asarray(ks, np.uint64)
        vals = [self._map[k] for k in ks]
        tombs = np.asarray([v is TOMBSTONE for v in vals], bool)
        return keys, vals, tombs

    def clear(self) -> None:
        self._map.clear()
