"""Append-only, CRC-framed write-ahead log for the LSM store.

A copy of ``repro/store/wal.py``: both packages write byte-identical
logs for the same op stream, and either replays the other's.

Durability contract: ``put``/``delete``/``delete_many``
append a framed record *before* the memtable acks the write, so a crash
between ack and the next checkpoint loses nothing — reopening the store
replays the log and reproduces every acknowledged write.  The log only
resets at :meth:`Store.checkpoint` time, after the snapshot + manifest
have been atomically renamed into place; replay is idempotent (the store
is last-write-wins), so a crash between the manifest rename and the WAL
reset merely replays records the snapshot already holds.

Frame format (little-endian)::

    u32 length | u32 crc32(payload) | payload bytes

The payload is a pickled ``(op, key, value)`` record with ``op`` one of
``"put"`` / ``"del"`` / ``"delm"`` (batched delete; ``key`` is a list).
Appends are buffered through one ``BufferedWriter`` and flushed to the OS
per record (``sync="always"`` additionally fsyncs — power-failure-proof
at a heavy per-op cost; the default ``"flush"`` survives process
crashes, the threat model of the fuzz harness).

**Truncated-tail tolerance**: a crash can tear the final frame (short
header, short payload, or a CRC mismatch from a partial write).
:meth:`Wal.replay` yields every intact record and stops at the first bad
frame; :meth:`Wal.open_for_append` then truncates the file back to the
last good frame boundary so later appends never sit behind an unreadable
gap.  Torn bytes can only belong to the record being written at crash
time — an un-acked write — so dropping them never loses acknowledged
data.
"""
from __future__ import annotations

import io
import os
import pickle
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace

__all__ = ["Wal", "WalRecord", "WAL_FILENAME"]

WAL_FILENAME = "wal.log"
_HEADER = struct.Struct("<II")          # (payload length, crc32)
_MAX_RECORD = 1 << 28                   # 256 MiB sanity cap per frame

WalRecord = Tuple[str, object, object]  # (op, key, value)
_OPS = ("put", "del", "delm")


class Wal:
    """One append-only log file with CRC-framed records."""

    def __init__(self, path: str, sync: str = "flush"):
        if sync not in ("flush", "always"):
            raise ValueError(f"sync must be 'flush' or 'always', got {sync!r}")
        self.path = path
        self.sync = sync
        self._f: Optional[io.BufferedWriter] = None
        #: records lost to a torn tail at the last open (un-acked writes)
        self.torn_bytes = 0

    # -- write side -------------------------------------------------------
    def open_for_append(self) -> "Wal":
        """Open (creating if absent), healing any torn tail first."""
        good = self.scan_valid_prefix()
        self._f = open(self.path, "r+b" if os.path.exists(self.path)
                       else "w+b")
        self._f.seek(0, os.SEEK_END)
        end = self._f.tell()
        if good < end:                  # tear off the unreadable tail
            self.torn_bytes = end - good
            self._f.truncate(good)
            self._f.seek(good)
        return self

    def append(self, op: str, key, value=None) -> None:
        if op not in _OPS:
            raise ValueError(f"unknown WAL op {op!r}")
        if self._f is None:
            self.open_for_append()
        with _obs_trace.span("wal/append"):
            payload = pickle.dumps((op, key, value),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            self._f.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
            self._f.write(payload)
            self._f.flush()
            if self.sync == "always":
                os.fsync(self._f.fileno())
        if _obs_metrics.enabled():
            _obs_metrics.registry().counter("wal/appends").add(1)

    def reset(self) -> None:
        """Drop every record (post-checkpoint): the snapshot now owns them."""
        if self._f is None:
            self._f = open(self.path, "w+b")
        self._f.seek(0)
        self._f.truncate(0)
        self._f.flush()
        if self.sync == "always":
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    # -- read side --------------------------------------------------------
    def scan_valid_prefix(self) -> int:
        """Byte offset of the last intact frame boundary (0 for no file)."""
        if not os.path.exists(self.path):
            return 0
        good = 0
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                length, crc = _HEADER.unpack(header)
                if length > _MAX_RECORD:
                    break               # garbage header — treat as torn
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break
                good = f.tell()
        return good

    def replay(self) -> Iterator[WalRecord]:
        """Yield every intact record; stop silently at the first bad frame
        (torn tail).  Never raises on a truncated or corrupted tail."""
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    return
                length, crc = _HEADER.unpack(header)
                if length > _MAX_RECORD:
                    return
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return
                try:
                    op, key, value = pickle.loads(payload)
                except Exception:       # CRC passed but payload garbage:
                    return              # treat like a torn frame
                if op not in _OPS:
                    return
                yield op, key, value

    def records(self) -> List[WalRecord]:
        return list(self.replay())

    def __len__(self) -> int:
        return sum(1 for _ in self.replay())
