"""Dispatch over the CUDA kernels, with the plain engine path beside them.

Counterpart of ``repro/kernels/ops.py``.  The resident/partitioned
threshold keeps the reference's knob unchanged, so each layout picks the
same tier as in ``repro``: filters of up to ``vmem_budget_u32`` lanes take
the "resident" kernels.  The default comes from the
``BLOOMRF_VMEM_BUDGET_U32`` environment variable (validated every time it
is read: non-integer or <= 0 raises a ``ValueError`` naming the variable)
and falls back to 2^22 lanes.  That figure sized a TPU core's VMEM; on
Hopper the "resident" kernels read the filter through L2 and device memory,
and a default measured on the card replaces this one later (ROADMAP).

Larger filters take the partitioned kernels for point and range probes,
as in ``repro``.  Inserts take the insert kernel on both tiers: the
reference's partitioned insert is the XLA engine, whose counterpart here
would be the plain version on a CUDA tensor, and the insert kernel has no
size limit on Hopper (one global ``atomicOr`` per bit).  The state is bit
for bit the same either way.

Stacked probes over ``R`` same-layout rows dispatch as in ``repro``: the
stacked kernels while ``R * total_u32`` fits the budget, the plain
``StackedProbe`` above it, and per-row plain probes for exact layouts.

With ``obs`` on, each call counts one ``kernel/dispatch/<tier>`` (the
tier it took: ``resident``, ``partitioned`` or ``xla`` for the plain path)
and runs in a ``kernel/insert|point|range`` span, as in ``repro``; an
insert counts the tier of its filter's size, where the reference counts
its XLA insert above the budget as ``xla``.  Neither adds a launch.
"""
from __future__ import annotations

import os

import torch

from ..core import FilterLayout
from ..core.engine import stacked_probe
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from . import insert as _insert
from . import probe as _probe
from . import rangeprobe as _rangeprobe
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["FilterOps", "DEFAULT_VMEM_BUDGET_U32", "read_vmem_budget_u32"]


def _tick(tier: str) -> None:
    """Count one dispatch on its tier (a host int: never a sync)."""
    if _obs_metrics.enabled():
        _obs_metrics.registry().counter(f"kernel/dispatch/{tier}").add(1)


#: fallback resident/partitioned threshold in uint32 lanes
DEFAULT_VMEM_BUDGET_U32 = 1 << 22


def read_vmem_budget_u32() -> int:
    """The resident/partitioned threshold in uint32 lanes.

    Reads ``BLOOMRF_VMEM_BUDGET_U32`` on every call and validates it at read
    time: a value that does not parse as an integer, or is <= 0, raises a
    ``ValueError`` that names the variable."""
    raw = os.environ.get("BLOOMRF_VMEM_BUDGET_U32")
    if raw is None:
        return DEFAULT_VMEM_BUDGET_U32
    try:
        val = int(raw)
    except ValueError:
        raise ValueError(
            f"BLOOMRF_VMEM_BUDGET_U32 must be an integer lane count, "
            f"got {raw!r}") from None
    if val <= 0:
        raise ValueError(
            f"BLOOMRF_VMEM_BUDGET_U32 must be > 0 lanes, got {val}")
    return val


class FilterOps:
    """Layout-bound kernel dispatcher.

    * filters of up to ``vmem_budget_u32`` lanes (``resident``) -> the
      resident point and range kernels;
    * larger filters -> the partitioned point and range kernels;
    * inserts -> the insert kernel on both tiers;
    * exact-layer layouts (range) -> the plain engine path (its middle scan
      is answered from the exact segment);
    * stacked rows -> the stacked kernels within the budget, the plain
      ``StackedProbe`` above it, per-row plain probes for exact layouts.

    Each kernel wrapper launches on a CUDA state and takes its plain
    version on a CPU state.
    """

    def __init__(self, layout: FilterLayout,
                 vmem_budget_u32: int | None = None):
        check_kernel_layout(layout)
        self.layout = layout
        self.vmem_budget_u32 = (read_vmem_budget_u32()
                                if vmem_budget_u32 is None else vmem_budget_u32)
        self.resident = layout.total_u32 <= self.vmem_budget_u32

    def _tier(self) -> str:
        return "resident" if self.resident else "partitioned"

    def insert(self, state: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        with _obs_trace.span("kernel/insert"):
            _tick(self._tier())
            return _insert.insert_resident(self.layout, state, keys)

    def point(self, state: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        with _obs_trace.span("kernel/point"):
            _tick(self._tier())
            if self.resident:
                return _probe.point_probe_resident(self.layout, state, keys)
            return _probe.point_probe_partitioned(self.layout, state, keys)

    def range(self, state: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
        with _obs_trace.span("kernel/range"):
            if self.layout.has_exact:  # middle scan: the plain engine path
                _tick("xla")
                return filter_for_layout(self.layout, state.device).range(
                    state, lo, hi)
            _tick(self._tier())
            if self.resident:
                return _rangeprobe.range_probe_resident(self.layout, state,
                                                        lo, hi)
            return _rangeprobe.range_probe_partitioned(self.layout, state,
                                                       lo, hi)

    # -- stacked-run probes (R same-layout rows, one launch) --------------
    def _stacked(self, stack: torch.Tensor):
        R, u = stack.shape
        return stacked_probe((self.layout,) * R,
                             tuple(r * u for r in range(R)), stack.device)

    def range_stacked(self, stack: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor) -> torch.Tensor:
        """(B, R) range verdicts over an ``int32[R, total_u32]`` stack."""
        if self.layout.has_exact:
            plain = filter_for_layout(self.layout, stack.device)
            return torch.stack([plain.range(row, lo, hi) for row in stack],
                               dim=1)
        if stack.shape[0] * self.layout.total_u32 <= self.vmem_budget_u32:
            _tick("resident")
            return _rangeprobe.range_probe_stacked_resident(
                self.layout, stack, lo, hi)
        _tick("xla")
        return self._stacked(stack).range_all(stack.reshape(-1), lo, hi)

    def point_stacked(self, stack: torch.Tensor,
                      keys: torch.Tensor) -> torch.Tensor:
        """(B, R) point verdicts over an ``int32[R, total_u32]`` stack."""
        if self.layout.has_exact:
            plain = filter_for_layout(self.layout, stack.device)
            return torch.stack([plain.point(row, keys) for row in stack],
                               dim=1)
        if stack.shape[0] * self.layout.total_u32 <= self.vmem_budget_u32:
            _tick("resident")
            return _probe.point_probe_stacked_resident(self.layout, stack,
                                                       keys)
        _tick("xla")
        return self._stacked(stack).point_all(stack.reshape(-1), keys)
