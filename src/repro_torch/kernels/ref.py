"""Plain-torch oracles for the CUDA kernels.

The oracles are pinned to the port's scalar reference path
(``BloomRF.point_reference`` / ``range_reference`` — per-key probes batched
natively), NOT the plan->gather->combine engine the kernels' plain versions
run.  That keeps kernel parity a cross-implementation check.  Agreement
with ``repro`` itself is shown by the CPU tests, which run both packages on
the same inputs.  Kernels operate on 32-bit sub-domains (d <= 32).
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from ..core.engine import _filter_for_layout as filter_for_layout


def check_kernel_layout(layout: FilterLayout) -> None:
    if layout.d > 32:
        raise ValueError(
            "bloomRF kernels operate on 32-bit sub-domains; range-partition "
            "the 64-bit key space across shards first (DESIGN.md §3)")


def point_ref(layout: FilterLayout, state: torch.Tensor, keys: torch.Tensor):
    check_kernel_layout(layout)
    return filter_for_layout(layout, state.device).point_reference(state, keys)


def range_ref(layout: FilterLayout, state: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor):
    check_kernel_layout(layout)
    return filter_for_layout(layout, state.device).range_reference(state, lo,
                                                                   hi)


def insert_ref(layout: FilterLayout, state: torch.Tensor, keys: torch.Tensor):
    check_kernel_layout(layout)
    return filter_for_layout(layout, state.device).insert(state, keys)


def positions_ref(layout: FilterLayout, keys: torch.Tensor):
    """(B, P) bit positions probed/set per key."""
    check_kernel_layout(layout)
    return filter_for_layout(layout, keys.device).positions(keys)
