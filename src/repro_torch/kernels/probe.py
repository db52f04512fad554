"""bloomRF batched point probe: the CUDA kernel ``csrc/probe.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/probe.py::point_probe_resident``.  On the TPU the filter is
pinned in VMEM; on Hopper the kernel reads it through L2 and device memory,
one thread per key.  On a CPU state the wrapper takes the plain version,
the engine's ``point_batched``.

The stacked and partitioned point kernels (``point_probe_stacked_resident``,
``point_probe_partitioned``) are not ported yet (ROADMAP B.6, B.7).
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from . import _build
from ._checks import check_keys, check_state
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["point_probe_resident"]


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
        _build.launch("probe", state.device, keys.data_ptr(), keys.numel(),
                      state.data_ptr(), desc.data_ptr(), desc.numel(),
                      out.data_ptr())
        point_probe_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
point_probe_resident.launches = 0
