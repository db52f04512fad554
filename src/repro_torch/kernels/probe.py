"""bloomRF batched point probe: the CUDA kernel ``csrc/probe.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/probe.py::point_probe_resident``.  On the TPU the filter is
pinned in VMEM; on Hopper the kernel reads it through L2 and device memory,
one thread per key.  On a CPU state the wrapper takes the plain version,
the engine's ``point_batched``.

``point_probe_stacked_resident`` replaces
``repro/kernels/probe.py::point_probe_stacked_resident``: the same probe
over ``R`` same-layout rows in one launch (``csrc/stacked.cu``); its plain
version is ``StackedProbe._point_all``.  The partitioned point kernel is
not ported yet (ROADMAP B.7).
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from ..core.engine import stacked_probe
from . import _build
from ._checks import check_keys, check_stack, check_state
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["point_probe_resident", "point_probe_stacked_resident"]


def point_probe_resident(layout: FilterLayout, state: torch.Tensor,
                         keys: torch.Tensor) -> torch.Tensor:
    """``bool[B]`` point verdicts for ``keys`` (int64 carriers of uint32
    codes) against ``state`` (int32 lanes)."""
    check_kernel_layout(layout)
    check_state(layout, state)
    check_keys("keys", keys, state.device)
    if state.device.type == "cpu":
        plain = filter_for_layout(layout, state.device)
        return plain.engine.point_batched(state, keys)
    out = torch.empty(keys.shape[0], dtype=torch.bool, device=state.device)
    if keys.numel():
        desc = _build.device_descriptor(layout, state.device)
        _build.launch("bloomrf_point_probe", state.device, keys.data_ptr(),
                      keys.numel(), state.data_ptr(), desc.data_ptr(),
                      desc.numel(), out.data_ptr())
        point_probe_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
point_probe_resident.launches = 0


def point_probe_stacked_resident(layout: FilterLayout, stack: torch.Tensor,
                                 keys: torch.Tensor) -> torch.Tensor:
    """``bool[B, R]`` point verdicts for ``keys`` (int64 carriers of uint32
    codes) against each row of ``stack`` (``int32[R, total_u32]`` lanes of
    one hashed layout)."""
    check_kernel_layout(layout)
    if layout.has_exact:
        raise ValueError("exact-layer layouts use per-row probes (ops.py)")
    check_stack(layout, stack)
    check_keys("keys", keys, stack.device)
    R, u = stack.shape
    if stack.device.type == "cpu":
        probe = stacked_probe((layout,) * R, tuple(r * u for r in range(R)),
                              stack.device)
        return probe.point_all(stack.reshape(-1), keys)
    out = torch.empty((keys.shape[0], R), dtype=torch.bool,
                      device=stack.device)
    if keys.numel():
        desc = _build.device_descriptor(layout, stack.device)
        _build.launch("bloomrf_point_stacked", stack.device, keys.data_ptr(),
                      keys.numel(), stack.data_ptr(), u, R, desc.data_ptr(),
                      desc.numel(), out.data_ptr())
        point_probe_stacked_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
point_probe_stacked_resident.launches = 0
