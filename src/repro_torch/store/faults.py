"""Deterministic fault injection for the store's tests.

A copy of the control-flow half of ``repro/store/faults.py``.  A
:class:`FaultPlan` arms *named seams* threaded through the store
(``Store._fault(point)`` calls :meth:`FaultPlan.hit`): when a seam's
countdown reaches zero the plan raises :class:`InjectedCrash`, simulating a
process death at exactly that point.

Seam names in the ported store: ``flush.after_run``,
``compact.before_swap`` and ``kernel.dispatch``.  The durability seams
(``wal.append``, ``snapshot.before_rename``, ``manifest.before_rename``),
the seeded byte-level corruption helpers and ``BLOOMRF_FAULT_SEED`` come
with the durability item (ROADMAP A.3b).

``fail_pallas`` arms the kernel-dispatch seam with a countdown of its own
(the name is the reference's).  Unlike the reference, the seam raises its
own :class:`InjectedDispatchFault`, and that is the only exception the
store's ``scan_backend="auto"`` retries on the plain path (counting
``StoreStats.kernel_fallbacks``): a kernel that really fails to build or
launch propagates.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["FaultPlan", "InjectedCrash", "InjectedDispatchFault"]


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


@dataclasses.dataclass
class FaultPlan:
    """Countdown-armed crash points.

    ``crashes`` maps seam name -> hit countdown: ``{"flush.after_run": 3}``
    crashes on the third flush.  ``fail_pallas`` is the countdown of the
    ``kernel.dispatch`` seam, which raises :class:`InjectedDispatchFault`
    (a dispatch failure is an error the store may absorb, not a process
    death)."""

    crashes: Dict[str, int] = dataclasses.field(default_factory=dict)
    fail_pallas: int = 0

    def __post_init__(self):
        for point, count in self.crashes.items():
            if count < 1:
                raise ValueError(f"crash countdown for {point!r} must be "
                                 f">= 1, got {count}")
        self._remaining = dict(self.crashes)
        self._pallas_left = int(self.fail_pallas)

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
