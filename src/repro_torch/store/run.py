"""Immutable sorted runs (the store's SSTables).

Counterpart of ``repro/store/run.py``.  A run is the unit the filters
prune: sorted unique keys, their values, a tombstone mask (deletes flushed
as markers), min/max key fences, and a bloomRF filter block over *all*
entry keys — tombstones included, so a newer run's delete marker is
discoverable through its filter and masks older runs on the read path.
The filter block is an ``int32[total_u32]`` tensor (uint32 lanes) on the
store's device.

A run whose filter block failed its checksum is *quarantined*: the store's
probe plane treats its row as always-maybe (fence-only pruning), because a
corrupted filter may answer "no" for a stored key.

Snapshots (``pack``/``unpack``, Elias-Fano posting lists) are not ported
yet (ROADMAP A.3b); :meth:`Run.from_numpy` carries a run across packages
in the meantime.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bloomrf import resolve_device
from ..core.layout import FilterLayout
from .integrity import run_checksums, verify_component

__all__ = ["Run"]


class Run:
    """One immutable sorted run with its filter block and fences."""

    __slots__ = ("keys", "vals", "tombs", "level", "layout", "state",
                 "promotions", "quarantined", "_crcs")

    def __init__(self, keys: np.ndarray, vals: list, tombs: np.ndarray,
                 level: int, layout: FilterLayout,
                 state: Optional[torch.Tensor], promotions: int = 0,
                 quarantined: bool = False):
        keys = np.asarray(keys, np.uint64)
        if keys.ndim != 1 or len(keys) == 0:
            raise ValueError("a run needs a non-empty 1-D key vector")
        if (keys[1:] <= keys[:-1]).any():
            raise ValueError("run keys must be strictly increasing")
        if len(vals) != len(keys) or len(tombs) != len(keys):
            raise ValueError("keys/vals/tombs length mismatch")
        self.keys = keys
        self.vals = vals
        self.tombs = np.asarray(tombs, bool)
        self.level = level
        self.layout = layout
        self.state = state            # int32[layout.total_u32] filter block
        # promote hops this filter block has survived without a rebuild
        # (always 0 until promote merges are ported, ROADMAP A.2b)
        self.promotions = int(promotions)
        # a quarantined run's filter block failed its checksum: the probe
        # plane must treat the row as always-maybe (fence-only pruning)
        self.quarantined = bool(quarantined)
        self._crcs: Optional[dict] = None

    @classmethod
    def from_numpy(cls, keys: np.ndarray, vals: list, tombs: np.ndarray,
                   level: int, layout: dict, state: Optional[np.ndarray],
                   quarantined: bool = False, promotions: int = 0,
                   device=None) -> "Run":
        """A run from host data: ``layout`` in its ``dataclasses.asdict``
        form and ``state`` as ``uint32[total_u32]`` lanes (or None), e.g. a
        ``repro`` run's ``np.asarray(run.state)``.  The state lands on
        ``device`` (default ``"cuda"``)."""
        lay = FilterLayout.from_dict(layout)
        lanes = None
        if state is not None:
            state = np.asarray(state)
            if state.dtype != np.uint32 or state.shape != (lay.total_u32,):
                raise ValueError(f"state must be uint32[{lay.total_u32}], got "
                                 f"{state.dtype}{list(state.shape)}")
            lanes = torch.from_numpy(state.view(np.int32).copy()).to(
                resolve_device(device))
        return cls(keys, vals, tombs, level, lay, lanes,
                   promotions=promotions, quarantined=quarantined)

    def state_numpy(self) -> Optional[np.ndarray]:
        """A host copy of the filter block as ``uint32`` lanes (or None)."""
        if self.state is None:
            return None
        return self.state.cpu().numpy().view(np.uint32).copy()

    # -- fences ----------------------------------------------------------
    @property
    def kmin(self) -> int:
        return int(self.keys[0])

    @property
    def kmax(self) -> int:
        return int(self.keys[-1])

    def __len__(self) -> int:
        return len(self.keys)

    def data_bytes(self, value_bytes: int = 64) -> int:
        """Accounting size of the run's data blocks (not the filter)."""
        return len(self.keys) * (8 + value_bytes)

    # -- integrity -------------------------------------------------------
    def checksums(self) -> dict:
        """Per-component CRC32s, computed once and cached (the store
        computes them at flush and compaction: the build-time reference
        :meth:`verify` compares against)."""
        if self._crcs is None:
            self._crcs = run_checksums(self.keys, self.vals, self.tombs,
                                       self.kmin, self.kmax,
                                       state=self.state)
        return self._crcs

    def verify(self) -> dict:
        """Recompute every component CRC against the cached reference.

        Returns ``{component: bool}``; a missing reference (never
        checksummed) verifies vacuously true."""
        ref = self._crcs
        fresh = run_checksums(self.keys, self.vals, self.tombs,
                              self.kmin, self.kmax, state=self.state)
        if ref is None:
            return {k: True for k in fresh}
        return {k: verify_component(ref, k, v) for k, v in fresh.items()}

    # -- data-block reads (the part the filters try to avoid) ------------
    def lookup(self, key: int) -> Tuple[bool, object, bool]:
        """(found, value, is_tombstone) via binary search."""
        i = int(np.searchsorted(self.keys, np.uint64(key)))
        if i < len(self.keys) and self.keys[i] == np.uint64(key):
            return True, self.vals[i], bool(self.tombs[i])
        return False, None, False

    def slice(self, lo: int, hi: int) -> Tuple[np.ndarray, list, np.ndarray]:
        """Entries with lo <= key <= hi (inclusive bounds, like Store.scan)."""
        a, b = np.searchsorted(self.keys, [np.uint64(lo), np.uint64(hi)])
        if b < len(self.keys) and self.keys[b] == np.uint64(hi):
            b += 1
        return self.keys[a:b], self.vals[a:b], self.tombs[a:b]

    # -- snapshots (not ported yet) ----------------------------------------
    def pack(self) -> dict:
        raise NotImplementedError(
            "run snapshots need the Elias-Fano half of dist/compression.py "
            "(ROADMAP A.3b); Run.from_numpy carries a run across packages")

    @classmethod
    def unpack(cls, enc: dict) -> "Run":
        raise NotImplementedError(
            "run snapshots need the Elias-Fano half of dist/compression.py "
            "(ROADMAP A.3b); Run.from_numpy carries a run across packages")
