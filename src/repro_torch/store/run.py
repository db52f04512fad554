"""Immutable sorted runs (the store's SSTables).

Counterpart of ``repro/store/run.py``.  A run is the unit the filters
prune: sorted unique keys, their values, a tombstone mask (deletes flushed
as markers), min/max key fences, and a bloomRF filter block over *all*
entry keys — tombstones included, so a newer run's delete marker is
discoverable through its filter and masks older runs on the read path.
The filter block is an ``int32[total_u32]`` tensor (uint32 lanes) on the
store's device.

Runs snapshot via ``dist/compression.py``: the key list and the filter's
set-bit positions are sorted integer lists, so :meth:`Run.pack` writes two
Elias-Fano posting lists, and :meth:`Run.unpack` restores the run bit for
bit.  The snapshot holds only numpy arrays and Python objects: the state
is copied to the host and viewed as ``uint32`` first, the layout is its
``dataclasses.asdict`` form, and tombstoned values are ``None``.  So the
dict is the reference's, field for field, and a snapshot written by either
package restores in the other.

v3 snapshots carry per-component CRC32s (``store/integrity.py``) over the
keys, fences, values, tombstones and decoded filter state.
:meth:`Run.unpack` verifies them: a key/fence/value mismatch is
unrecoverable data corruption and raises a ``ValueError``, while a
filter-block mismatch (or an undecodable filter payload) *quarantines* the
run: the store's probe plane treats its row as always-maybe (fence-only
pruning), because a corrupted filter may answer "no" for a stored key.
Scans through a quarantined run stay exact, just less pruned.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bloomrf import resolve_device
from ..core.layout import FilterLayout
from ..dist.compression import (elias_fano_decode, elias_fano_encode,
                                pack_filter_state, unpack_filter_state)
from .integrity import run_checksums, state_crc32, verify_component
from .memtable import TOMBSTONE

__all__ = ["Run"]

_SNAPSHOT_SCHEMA = "bloomrf-run/v3"
_ACCEPTED_SCHEMAS = ("bloomrf-run/v1", "bloomrf-run/v2", "bloomrf-run/v3")


class Run:
    """One immutable sorted run with its filter block and fences."""

    __slots__ = ("keys", "vals", "tombs", "level", "layout", "state", "alt",
                 "promotions", "quarantined", "_crcs")

    def __init__(self, keys: np.ndarray, vals: list, tombs: np.ndarray,
                 level: int, layout: FilterLayout,
                 state: Optional[torch.Tensor], alt=None,
                 promotions: int = 0, quarantined: bool = False):
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
        self.alt = alt                # optional host baseline (filters/)
        # promote hops this filter block has survived without a rebuild: a
        # promoted segment answers at the source class's resolution, so
        # each hop multiplies FPR by the source count (the store caps hops
        # with promote_max_hops)
        self.promotions = int(promotions)
        # a quarantined run's filter block failed its checksum: the probe
        # plane must treat the row as always-maybe (fence-only pruning)
        self.quarantined = bool(quarantined)
        self._crcs: Optional[dict] = None

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

    # -- snapshots (Elias-Fano, dist/compression.py) ---------------------
    def pack(self) -> dict:
        """Compressed snapshot: EF posting lists for keys + filter bits.

        Tombstoned slots store a ``None`` placeholder, not the in-process
        ``TOMBSTONE`` sentinel; ``unpack`` restores the sentinel from the
        tombstone mask.  v3 adds the per-component ``crc`` dict (the
        build-time reference when the run was checksummed at construction,
        else computed now)."""
        enc = {
            "schema": _SNAPSHOT_SCHEMA,
            "level": self.level,
            "layout": dataclasses.asdict(self.layout),
            "keys": elias_fano_encode(self.keys, universe=1 << 64),
            "vals": [None if t else v
                     for v, t in zip(self.vals, self.tombs)],
            "tombs": np.packbits(self.tombs),
            "n": len(self.keys),
            "promotions": self.promotions,
            "crc": dict(self.checksums()),
        }
        if self.quarantined:
            enc["quarantined"] = True
        if self.state is not None:
            enc["filter"] = pack_filter_state(self.state_numpy())
        return enc

    @classmethod
    def unpack(cls, enc: dict, device=None) -> "Run":
        """Validated inverse of :meth:`pack`, the filter state placed on
        ``device`` (default ``"cuda"``).  Host baselines do not snapshot:
        the store rebuilds a run's ``alt`` after unpacking it.

        Every malformed or corrupted input raises ``ValueError`` naming
        what failed; the one exception is a corrupt *filter block*, which
        degrades to a quarantined run instead (see the module
        docstring)."""
        if not isinstance(enc, dict):
            raise ValueError(f"run snapshot must be a dict, "
                             f"got {type(enc).__name__}")
        if enc.get("schema") not in _ACCEPTED_SCHEMAS:
            raise ValueError(f"not a run snapshot: {enc.get('schema')!r}")
        device = resolve_device(device)
        # checksums are a v3 field: v1/v2 snapshots predate them and are
        # accepted unverified whatever stray keys they carry
        crcs = enc.get("crc") if enc.get("schema") == _SNAPSHOT_SCHEMA \
            else None
        if crcs is not None and not isinstance(crcs, dict):
            raise ValueError("run snapshot: 'crc' must be a dict")
        try:
            layout = FilterLayout.from_dict(enc["layout"])
        except Exception as e:
            raise ValueError(f"run snapshot: bad filter layout: {e}") from e
        try:
            n = int(enc["n"])
            level = int(enc["level"])
            promotions = int(enc.get("promotions", 0))
        except Exception as e:
            raise ValueError(f"run snapshot: bad scalar field: {e}") from e
        if n < 1:
            raise ValueError(f"run snapshot: n must be >= 1, got {n}")
        try:
            keys = elias_fano_decode(enc["keys"])
        except Exception as e:
            raise ValueError(f"run snapshot: undecodable key list: {e}") from e
        if len(keys) != n or keys.dtype != np.uint64:
            raise ValueError(f"run snapshot: decoded {len(keys)} keys, "
                             f"expected n={n}")
        if len(keys) > 1 and (keys[1:] <= keys[:-1]).any():
            raise ValueError("run snapshot: keys not strictly increasing "
                             "(corrupted key posting list)")
        kmin, kmax = int(keys[0]), int(keys[-1])
        try:
            tombs = np.unpackbits(np.asarray(enc["tombs"], np.uint8))[:n]
            tombs = tombs.astype(bool)
        except Exception as e:
            raise ValueError(f"run snapshot: bad tombstone mask: {e}") from e
        if len(tombs) != n:
            raise ValueError(f"run snapshot: tombstone mask covers "
                             f"{len(tombs)} entries, expected {n}")
        enc_vals = enc["vals"]
        if not isinstance(enc_vals, list) or len(enc_vals) != n:
            got = (len(enc_vals) if isinstance(enc_vals, list)
                   else type(enc_vals).__name__)
            raise ValueError(f"run snapshot: expected {n} values, got {got}")
        # keys / fences / values / tombstones are data: a mismatch is
        # unrecoverable corruption and must not restore.  The vals CRC is
        # computed against the *decoded* mask; tomb->live flips are
        # invisible to it and caught by the tombs component instead.
        fresh = run_checksums(keys, enc_vals, tombs, kmin, kmax)
        for comp in ("keys", "fences", "vals", "tombs"):
            if not verify_component(crcs, comp, fresh[comp]):
                raise ValueError(
                    f"run snapshot: {comp} CRC mismatch — the snapshot is "
                    f"corrupted; restore from a previous checkpoint")
        # filter block: corruption degrades (quarantine), never raises
        state = None
        quarantined = bool(enc.get("quarantined", False))
        if "filter" in enc:
            try:
                state_np = unpack_filter_state(enc["filter"],
                                               layout.total_u32)
                if not verify_component(crcs, "filter",
                                        state_crc32(state_np)):
                    quarantined = True
            except Exception:
                # undecodable filter payload: keep the run alive without a
                # usable filter block (the store stacks zeros in its place
                # and the quarantine mask keeps the row always-touch)
                state_np = None
                quarantined = True
            if state_np is not None:
                # outside the try: a failed copy to the device raises
                state = torch.from_numpy(state_np.view(np.int32)).to(device)
        # the tombstone mask is authoritative: restoring the sentinel from
        # it also heals v1 snapshots whose vals hold stale sentinels
        vals = [TOMBSTONE if t else v for v, t in zip(enc_vals, tombs)]
        try:
            run = cls(keys, vals, tombs, level, layout, state,
                      promotions=promotions, quarantined=quarantined)
        except Exception as e:
            raise ValueError(f"run snapshot: inconsistent run: {e}") from e
        if crcs is not None and not quarantined:
            run._crcs = dict(crcs)    # carry the build-time reference
        return run
