"""Per-run component checksums.

A copy of the checksum half of ``repro/store/integrity.py``:
:func:`run_checksums` covers each durable component of a run separately
(filter state, keys, fences, values, tombstones), so a mismatch says which
component rotted.  A filter-block mismatch quarantines the run (the probe
plane degrades that row to fence-only pruning); a key, fence or value
mismatch is data corruption.  The CRCs equal the reference's for the same
run: a filter state is checksummed over its uint32 lanes, read back to the
host with ``.cpu()``.

The atomic file replacement and the checksummed manifest come with the
durability item (ROADMAP A.3b).
"""
from __future__ import annotations

import pickle
import struct
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["crc32_bytes", "state_crc32", "run_checksums", "verify_component"]


def crc32_bytes(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def state_crc32(state) -> int:
    """CRC32 over a filter block's raw u32 lanes (an int32-lane tensor on
    any device, or a host array)."""
    if isinstance(state, torch.Tensor):
        state = state.cpu().numpy().view(np.uint32)
    return crc32_bytes(np.ascontiguousarray(
        np.asarray(state, np.uint32)).tobytes())


def _keys_crc32(keys: np.ndarray) -> int:
    return crc32_bytes(np.ascontiguousarray(
        np.asarray(keys, np.uint64)).tobytes())


def _fence_crc32(kmin: int, kmax: int) -> int:
    return crc32_bytes(struct.pack("<QQ", kmin, kmax))


def _vals_crc32(vals, tombs) -> int:
    # tombstone slots carry a process-local sentinel; checksum them as None
    # (exactly the form a run snapshot serialises)
    clean = [None if t else v for v, t in zip(vals, tombs)]
    return crc32_bytes(pickle.dumps(clean, protocol=pickle.HIGHEST_PROTOCOL))


def run_checksums(keys: np.ndarray, vals, tombs, kmin: int, kmax: int,
                  state=None) -> dict:
    """Component CRC dict (``filter`` key only when a bloomRF state block
    exists).

    The tombstone mask gets its own component: the vals CRC alone cannot
    see a tomb->live bit flip (both sides serialise the slot as ``None``),
    and a flipped mask silently turns a delete back into a live entry."""
    tombs_arr = np.asarray(tombs, bool)
    crc = {
        "keys": _keys_crc32(keys),
        "fences": _fence_crc32(kmin, kmax),
        "vals": _vals_crc32(vals, tombs_arr),
        "tombs": crc32_bytes(np.packbits(tombs_arr).tobytes()),
    }
    if state is not None:
        crc["filter"] = state_crc32(state)
    return crc


def verify_component(crcs: Optional[dict], name: str, actual: int) -> bool:
    """True when the recorded CRC matches (or none was recorded)."""
    if not crcs or name not in crcs:
        return True
    return int(crcs[name]) == int(actual)
