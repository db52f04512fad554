"""Checksums, the atomic manifest, and corruption containment.

A copy of ``repro/store/integrity.py``.  Three jobs:

* **Per-run component CRCs**: :func:`run_checksums` covers each durable
  component of a run separately (filter state, keys, fences, values,
  tombstones), so a mismatch says which component rotted.  A filter-block
  mismatch quarantines the run (the probe plane degrades that row to
  fence-only pruning); a key, fence or value mismatch is data corruption.
  The CRCs equal the reference's for the same run: a filter state is
  checksummed over its uint32 lanes, read back to the host with ``.cpu()``.
* **Atomic file replacement**: :func:`atomic_write_bytes` writes a temp
  file in the destination directory and ``os.replace``-renames it over
  the target, so a crash at any byte offset leaves either the old file or
  the new one.  Snapshots and the manifest both go through it.
* **The checksummed manifest**: a small self-checksummed JSON document
  (:func:`write_manifest` / :func:`read_manifest`) naming the current
  snapshot file and its whole-file CRC.  Recovery trusts nothing it
  cannot verify: manifest CRC first, then the snapshot CRC against the
  manifest's record, then every run's component CRCs.
"""
from __future__ import annotations

import json
import os
import pickle
import struct
import tempfile
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = [
    "crc32_bytes", "state_crc32", "run_checksums", "verify_component",
    "atomic_write_bytes", "write_manifest", "read_manifest",
    "MANIFEST_FILENAME", "SNAPSHOT_SCHEMA_MANIFEST",
]

MANIFEST_FILENAME = "MANIFEST.json"
SNAPSHOT_SCHEMA_MANIFEST = "bloomrf-manifest/v1"


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


# ---------------------------------------------------------------------------
# atomic replace + the manifest
# ---------------------------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes, *, fault=None,
                       fault_point: str = "") -> None:
    """Write ``data`` to ``path`` via temp-file + ``os.replace``.

    ``fault``/``fault_point`` thread the fault-injection harness through
    the commit point: a :class:`~repro_torch.store.faults.FaultPlan` armed at
    ``fault_point`` crashes *after* the temp file is complete but
    *before* the rename — the crash the atomicity argument is about."""
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp-",
                               suffix=os.path.basename(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        if fault is not None and fault_point:
            fault.hit(fault_point)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def write_manifest(directory: str, payload: dict, *, fault=None) -> None:
    """Atomically publish a self-checksummed manifest.

    ``payload`` names the snapshot file and its CRC; the manifest wraps it
    with its own CRC over the canonical JSON encoding, so a torn or
    bit-flipped manifest is detected before anything it references is
    trusted."""
    payload = dict(payload, schema=SNAPSHOT_SCHEMA_MANIFEST)
    body = json.dumps(payload, sort_keys=True)
    doc = {"payload": payload, "crc": crc32_bytes(body.encode())}
    atomic_write_bytes(os.path.join(directory, MANIFEST_FILENAME),
                       json.dumps(doc).encode(),
                       fault=fault, fault_point="manifest.before_rename")


def read_manifest(directory: str) -> Optional[dict]:
    """Verified manifest payload, or None when no manifest exists.

    Raises ``ValueError`` on a corrupt manifest (bad JSON, missing
    fields, CRC mismatch, unknown schema) — recovery must not guess."""
    path = os.path.join(directory, MANIFEST_FILENAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt store manifest {path!r}: {e}") from e
    if not isinstance(doc, dict) or "payload" not in doc or "crc" not in doc:
        raise ValueError(f"corrupt store manifest {path!r}: "
                         f"missing payload/crc envelope")
    payload = doc["payload"]
    body = json.dumps(payload, sort_keys=True)
    if crc32_bytes(body.encode()) != doc["crc"]:
        raise ValueError(f"corrupt store manifest {path!r}: CRC mismatch "
                         f"(torn write or bit rot — restore from backup)")
    if payload.get("schema") != SNAPSHOT_SCHEMA_MANIFEST:
        raise ValueError(f"unknown manifest schema "
                         f"{payload.get('schema')!r} in {path!r}")
    return payload
