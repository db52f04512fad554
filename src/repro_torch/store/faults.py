"""Deterministic fault injection for the store's crash-recovery tests.

Counterpart of ``repro/store/faults.py``.  A :class:`FaultPlan` arms
*named seams* threaded through the store's write, flush, compaction and
checkpoint paths (``Store._fault(point)`` calls :meth:`FaultPlan.hit`):
when a seam's countdown reaches zero the plan raises
:class:`InjectedCrash`, simulating a process death at exactly that point.
The test then throws the live ``Store`` away and reopens from disk.

Seam names in the store:

* ``wal.append``            — before a WAL record is framed (the write is
  lost, but it was never acked either);
* ``flush.after_run``       — after the memtable froze into a run, before
  anything durable changed (recovery replays the WAL);
* ``compact.before_swap``   — after the merged run and its filter are
  built, before the level-list swap (the old runs stay live);
* ``snapshot.before_rename`` / ``manifest.before_rename`` — between the
  temp file completing and the ``os.replace`` commit point;
* ``kernel.dispatch``       — before the store-scan kernel's launch.

Byte-level corruptions are separate helpers (they damage files, not
control flow): :func:`truncate_tail` tears a file's final bytes and
:func:`flip_filter_bits` flips bits inside a packed run's filter block
(the quarantine trigger), both driven by the plan's seeded RNG so a
failure replays exactly (``BLOOMRF_FAULT_SEED``).

``fail_pallas`` arms the kernel-dispatch seam with a countdown of its own
(the name is the reference's).  Unlike the reference, the seam raises its
own :class:`InjectedDispatchFault`, and that is the only exception the
store's ``scan_backend="auto"`` retries on the plain path (counting
``StoreStats.kernel_fallbacks``): a kernel that really fails to build or
launch propagates.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

__all__ = ["FaultPlan", "InjectedCrash", "InjectedDispatchFault",
           "truncate_tail", "flip_filter_bits", "fault_seed_from_env"]

FAULT_SEED_ENV = "BLOOMRF_FAULT_SEED"


class InjectedCrash(RuntimeError):
    """A simulated process death at a named seam (never caught by the
    store itself — it must unwind like a real crash would)."""

    def __init__(self, point: str):
        super().__init__(f"injected crash at {point!r}")
        self.point = point


class InjectedDispatchFault(RuntimeError):
    """A simulated failure to dispatch the store-scan kernel: the one error
    ``scan_backend="auto"`` absorbs by retrying the batch on the plain
    path."""


def fault_seed_from_env(default: int = 0xFA17) -> int:
    """The pinned fuzz seed (``BLOOMRF_FAULT_SEED``), else ``default``."""
    raw = os.environ.get(FAULT_SEED_ENV)
    if raw is None:
        return default
    try:
        return int(raw, 0)
    except ValueError as e:
        raise ValueError(f"{FAULT_SEED_ENV} must be an integer, "
                         f"got {raw!r}") from e


@dataclasses.dataclass
class FaultPlan:
    """Countdown-armed crash points + a seeded RNG for byte corruptions.

    ``crashes`` maps seam name -> hit countdown: ``{"wal.append": 3}``
    crashes on the third append.  ``fail_pallas`` is the countdown of the
    ``kernel.dispatch`` seam, which raises :class:`InjectedDispatchFault`
    (a dispatch failure is an error the store may absorb, not a process
    death)."""

    seed: int = 0xFA17
    crashes: Dict[str, int] = dataclasses.field(default_factory=dict)
    fail_pallas: int = 0

    def __post_init__(self):
        for point, count in self.crashes.items():
            if count < 1:
                raise ValueError(f"crash countdown for {point!r} must be "
                                 f">= 1, got {count}")
        self._remaining = dict(self.crashes)
        self._pallas_left = int(self.fail_pallas)
        self.rng = np.random.default_rng(self.seed)

    def hit(self, point: str) -> None:
        """Count a pass through ``point``; raise when its countdown ends."""
        if point == "kernel.dispatch":
            if self._pallas_left > 0:
                self._pallas_left -= 1
                raise InjectedDispatchFault(
                    "injected store-scan kernel dispatch failure (FaultPlan)")
            return
        left = self._remaining.get(point)
        if left is None:
            return
        if left <= 1:
            del self._remaining[point]
            raise InjectedCrash(point)
        self._remaining[point] = left - 1

    def armed(self, point: str) -> bool:
        if point == "kernel.dispatch":
            return self._pallas_left > 0
        return point in self._remaining


# ---------------------------------------------------------------------------
# byte-level corruptions
# ---------------------------------------------------------------------------

def truncate_tail(path: str, rng: Optional[np.random.Generator] = None,
                  max_bytes: int = 64) -> int:
    """Tear 1..``max_bytes`` bytes off a file's end (a torn final write).

    Returns the number of bytes removed (0 for an empty/absent file)."""
    rng = rng if rng is not None else np.random.default_rng(0)
    size = os.path.getsize(path) if os.path.exists(path) else 0
    if size == 0:
        return 0
    cut = int(rng.integers(1, min(max_bytes, size) + 1))
    with open(path, "r+b") as f:
        f.truncate(size - cut)
    return cut


def flip_filter_bits(enc: dict, rng: Optional[np.random.Generator] = None,
                     nbits: int = 1) -> dict:
    """Flip ``nbits`` random bits inside a packed run's filter payload.

    ``enc`` is a :meth:`Run.pack` dict; the flip lands in the Elias-Fano
    ``low`` plane of the packed filter (dense raw bits, so any flip
    changes decoded state without breaking the EF structure).  Returns a
    deep-enough copy — the input dict is not modified.  The component CRC
    recorded at pack time no longer matches, which is exactly what
    ``Run.unpack`` quarantines on."""
    if "filter" not in enc:
        raise ValueError("run snapshot has no filter block to corrupt")
    rng = rng if rng is not None else np.random.default_rng(0)
    enc = dict(enc)
    ef = dict(enc["filter"])            # {"n", "u", "l", "low", "high"}
    target = "low" if np.size(ef.get("low")) else "high"
    flat = np.array(ef[target], np.uint8, copy=True)
    if flat.size == 0:
        raise ValueError("filter payload too small to corrupt")
    for _ in range(nbits):
        i = int(rng.integers(0, flat.size))
        flat[i] ^= np.uint8(1 << int(rng.integers(0, 8)))
    ef[target] = flat
    enc["filter"] = ef
    return enc
