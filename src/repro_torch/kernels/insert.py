"""bloomRF bulk insert (filter build): the CUDA kernel ``csrc/insert.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/insert.py::insert_resident``.
On a CUDA state it launches the kernel, which ORs every key's bits into the
lanes with atomic ORs, the layout descriptor riding in the launch's
parameters; on a CPU state it takes the plain version,
``BloomRF.insert``.  Either way the state is updated in place and
returned; the bits equal ``ref.insert_ref`` exactly.
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from . import _build
from ._checks import check_keys, check_state
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["insert_resident"]


def insert_resident(layout: FilterLayout, state: torch.Tensor,
                    keys: torch.Tensor) -> torch.Tensor:
    """OR the bits of ``keys`` (int64 carriers of uint32 codes) into
    ``state`` (int32 lanes) in place; returns ``state``."""
    check_kernel_layout(layout)
    check_state(layout, state)
    check_keys("keys", keys, state.device)
    if state.device.type == "cpu":
        plain = filter_for_layout(layout, state.device)
        return state.copy_(plain.insert(state, keys))
    if keys.numel():
        desc = _build.param_descriptor(layout)
        _build.launch("bloomrf_insert", state.device, keys.data_ptr(),
                      keys.numel(), state.data_ptr(), desc.ctypes.data)
        insert_resident.launches += 1
    return state


#: kernel launches so far (a plain count; reset it by assignment)
insert_resident.launches = 0
