"""bloomRF batched range probes: the CUDA kernel ``csrc/partitioned.cu``
for both tiers of the single filter, and ``csrc/stacked.cu``.

``range_probe_resident`` replaces the Pallas TPU kernel
``repro/kernels/rangeprobe.py::range_probe_resident`` and
``range_probe_partitioned`` replaces
``repro/kernels/rangeprobe.py::range_probe_partitioned``, the tier of
filters above the resident budget.  On a CUDA state each is one launch of
the same kernel, counted by its own wrapper: one thread per range runs the
engine's range plan and combine in registers, reading per layer only the
words a live path can select, straight from L2 or device memory.

On a CPU state ``range_probe_resident`` takes the plain version, the
engine's ``range_batched``.  ``range_probe_partitioned``'s plain version
(``range_partitioned_plain``, and the wrapper on a CPU state) keeps the
reference's steps: the engine's range plan, its ``B * A`` lanes bucketed
by filter block (``probe._bucket_probes``), a torch gather and the
engine's combine.

``range_probe_stacked_resident`` replaces
``repro/kernels/rangeprobe.py::range_probe_stacked_resident``: one launch
for the whole ``(B, R)`` verdict matrix over ``R`` same-layout rows
(``csrc/stacked.cu``), one thread per range computing each layer's plan
once for all rows, the layout descriptor in the launch's parameters; its
plain version is ``StackedProbe._range_all``.

Exact-bitmap layouts are rejected, as by the TPU kernels: ``FilterOps``
routes their range queries to the engine path.
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from ..core.engine import stacked_probe
from . import _build
from ._checks import check_keys, check_stack, check_state
from .probe import (DEFAULT_BLOCK_U32, DEFAULT_TILE, _bucket_probes,
                    _check_tiling, gather_partitioned)
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["range_probe_resident", "range_probe_stacked_resident",
           "range_probe_partitioned", "range_partitioned_plain"]


def _check_range_kernel_layout(layout: FilterLayout) -> None:
    check_kernel_layout(layout)
    if layout.has_exact:
        raise ValueError("exact-layer layouts use the engine path (ops.py)")


def _check_bounds(lo, hi, device) -> None:
    check_keys("lo", lo, device)
    check_keys("hi", hi, device)
    if lo.shape != hi.shape:
        raise ValueError(f"lo {list(lo.shape)} and hi {list(hi.shape)} differ")


def _launch_range(layout: FilterLayout, state: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The verdicts from one launch of ``csrc/partitioned.cu``'s kernel
    (none for an empty batch); the calling wrapper counts the launch."""
    out = torch.empty(lo.shape[0], dtype=torch.bool, device=state.device)
    if lo.numel():
        desc = _build.device_descriptor(layout, state.device)
        _build.launch("bloomrf_range_partitioned", state.device,
                      lo.data_ptr(), hi.data_ptr(), lo.numel(),
                      state.data_ptr(), desc.data_ptr(), desc.numel(),
                      out.data_ptr())
    return out


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
    out = _launch_range(layout, state, lo, hi)
    if lo.numel():
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
        desc = _build.param_descriptor(layout)
        _build.launch("bloomrf_range_stacked", stack.device, lo.data_ptr(),
                      hi.data_ptr(), lo.numel(), stack.data_ptr(), u, R,
                      desc.ctypes.data, out.data_ptr())
        range_probe_stacked_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
range_probe_stacked_resident.launches = 0


# ---------------------------------------------------------------------------
# partitioned tier (filters above the resident budget)
# ---------------------------------------------------------------------------

def range_partitioned_words(state, lane_b, flat_b, tile_block, nprobe: int,
                            tile: int, block_u32: int) -> torch.Tensor:
    """The ``nprobe`` planned lanes as uint32 values in int64, in plan
    order, from their bucketed slots (``flat_b``: each slot's index in the
    plan, ``nprobe`` = the scrap slot at padding), by a torch gather."""
    vals = gather_partitioned(state, lane_b, tile_block, tile, block_u32)
    g = torch.zeros(nprobe + 1, dtype=torch.int64, device=state.device)
    g[flat_b.to(torch.int64)] = vals
    return g[:nprobe]


def _range_buckets(layout, state, lo, hi, tile, block_u32, nblocks):
    """The range plan and its ``B * A`` lanes bucketed by block: ``(plan,
    lane_b, flat_b, tile_block)``, plan index ``B * A`` (a scrap slot) at
    padding."""
    plan = filter_for_layout(layout, state.device).engine.plan_range(lo, hi)
    B, A = plan.lanes.shape
    if B * A >= 1 << 31:
        raise ValueError(f"{B} ranges x {A} plan lanes exceed the int32 "
                         f"word index; probe in smaller batches")
    order, slot, lane_b, tile_block, capr = _bucket_probes(
        plan.lanes.reshape(-1), tile, block_u32, nblocks)
    flat_b = torch.full((capr,), B * A, dtype=torch.int32,
                        device=state.device)
    flat_b[slot] = order.to(torch.int32)
    return plan, lane_b, flat_b, tile_block


def _check_range_partitioned(layout, state, lo, hi, tile, block_u32) -> int:
    _check_range_kernel_layout(layout)
    check_state(layout, state)
    _check_bounds(lo, hi, state.device)
    return _check_tiling(layout, tile, block_u32)


def _range_plain(layout, state, lo, hi, tile, block_u32, nblocks):
    if not lo.numel():
        return torch.zeros(0, dtype=torch.bool, device=state.device)
    plan, lane_b, flat_b, tile_block = _range_buckets(
        layout, state, lo, hi, tile, block_u32, nblocks)
    B, A = plan.lanes.shape
    g = range_partitioned_words(state, lane_b, flat_b, tile_block, B * A,
                                tile, block_u32)
    return filter_for_layout(layout, state.device).engine.combine_range(
        g.reshape(B, A), plan)


def range_probe_partitioned(layout: FilterLayout, state: torch.Tensor,
                            lo: torch.Tensor, hi: torch.Tensor,
                            tile: int = DEFAULT_TILE,
                            block_u32: int = DEFAULT_BLOCK_U32
                            ) -> torch.Tensor:
    """``bool[B]`` range verdicts for ``[lo, hi]`` (int64 carriers of uint32
    codes; swapped bounds allowed) against ``state`` (int32 lanes) of a
    filter of any size: one kernel launch on a CUDA state, which ignores
    ``tile`` and ``block_u32`` (the reference's tiling, still validated);
    the plain version on a CPU state."""
    nblocks = _check_range_partitioned(layout, state, lo, hi, tile,
                                       block_u32)
    if state.device.type == "cpu":
        return _range_plain(layout, state, lo, hi, tile, block_u32, nblocks)
    out = _launch_range(layout, state, lo, hi)
    if lo.numel():
        range_probe_partitioned.launches += 1
    return out


def range_partitioned_plain(layout: FilterLayout, state: torch.Tensor,
                            lo: torch.Tensor, hi: torch.Tensor,
                            tile: int = DEFAULT_TILE,
                            block_u32: int = DEFAULT_BLOCK_U32
                            ) -> torch.Tensor:
    """The plain version of :func:`range_probe_partitioned` on any device:
    the reference's plan, bucketing and combine, the read as a torch
    gather."""
    nblocks = _check_range_partitioned(layout, state, lo, hi, tile,
                                       block_u32)
    return _range_plain(layout, state, lo, hi, tile, block_u32, nblocks)


#: kernel launches so far (a plain count; reset it by assignment)
range_probe_partitioned.launches = 0
