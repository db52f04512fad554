"""bloomRF batched range probe: the CUDA kernel ``csrc/rangeprobe.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/rangeprobe.py::range_probe_resident``.  One thread per
query runs the engine's range plan and combine in registers, reading the
filter through L2 and device memory.  On a CPU state the wrapper takes the
plain version, the engine's ``range_batched``.

``range_probe_stacked_resident`` replaces
``repro/kernels/rangeprobe.py::range_probe_stacked_resident``: the same
per-thread plan over ``R`` same-layout rows, one launch for the whole
``(B, R)`` verdict matrix (``csrc/stacked.cu``); its plain version is
``StackedProbe._range_all``.

Exact-bitmap layouts are rejected, as by the TPU kernels: ``FilterOps``
routes their range queries to the engine path.  The partitioned range
kernel is not ported yet (ROADMAP B.8).
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from ..core.engine import stacked_probe
from . import _build
from ._checks import check_keys, check_stack, check_state
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["range_probe_resident", "range_probe_stacked_resident"]


def _check_range_kernel_layout(layout: FilterLayout) -> None:
    check_kernel_layout(layout)
    if layout.has_exact:
        raise ValueError("exact-layer layouts use the engine path (ops.py)")


def _check_bounds(lo, hi, device) -> None:
    check_keys("lo", lo, device)
    check_keys("hi", hi, device)
    if lo.shape != hi.shape:
        raise ValueError(f"lo {list(lo.shape)} and hi {list(hi.shape)} differ")


def range_probe_resident(layout: FilterLayout, state: torch.Tensor,
                         lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``bool[B]`` range verdicts for ``[lo, hi]`` (int64 carriers of uint32
    codes; swapped bounds allowed) against ``state`` (int32 lanes)."""
    _check_range_kernel_layout(layout)
    check_state(layout, state)
    _check_bounds(lo, hi, state.device)
    if state.device.type == "cpu":
        plain = filter_for_layout(layout, state.device)
        return plain.engine.range_batched(state, lo, hi)
    out = torch.empty(lo.shape[0], dtype=torch.bool, device=state.device)
    if lo.numel():
        desc = _build.device_descriptor(layout, state.device)
        _build.launch("bloomrf_range_probe", state.device, lo.data_ptr(),
                      hi.data_ptr(), lo.numel(), state.data_ptr(),
                      desc.data_ptr(), desc.numel(), out.data_ptr())
        range_probe_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
range_probe_resident.launches = 0


def range_probe_stacked_resident(layout: FilterLayout, stack: torch.Tensor,
                                 lo: torch.Tensor,
                                 hi: torch.Tensor) -> torch.Tensor:
    """``bool[B, R]`` range verdicts for ``[lo, hi]`` (int64 carriers of
    uint32 codes) against each row of ``stack`` (``int32[R, total_u32]``
    lanes of one layout)."""
    _check_range_kernel_layout(layout)
    check_stack(layout, stack)
    _check_bounds(lo, hi, stack.device)
    R, u = stack.shape
    if stack.device.type == "cpu":
        probe = stacked_probe((layout,) * R, tuple(r * u for r in range(R)),
                              stack.device)
        return probe.range_all(stack.reshape(-1), lo, hi)
    out = torch.empty((lo.shape[0], R), dtype=torch.bool, device=stack.device)
    if lo.numel():
        desc = _build.device_descriptor(layout, stack.device)
        _build.launch("bloomrf_range_stacked", stack.device, lo.data_ptr(),
                      hi.data_ptr(), lo.numel(), stack.data_ptr(), u, R,
                      desc.data_ptr(), desc.numel(), out.data_ptr())
        range_probe_stacked_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
range_probe_stacked_resident.launches = 0
