"""bloomRF batched point probe: the CUDA kernel ``csrc/probe.cu``.

Replaces the Pallas TPU kernel
``repro/kernels/probe.py::point_probe_resident``.  On the TPU the filter is
pinned in VMEM; on Hopper the kernel reads it through L2 and device memory,
one thread per key up to its first clear bit, the layout descriptor in the
launch's parameters (``_build.param_descriptor``).  On a CPU state the
wrapper takes the plain version, the engine's ``point_batched``.

``point_probe_stacked_resident`` replaces
``repro/kernels/probe.py::point_probe_stacked_resident``: the same probe
over ``R`` same-layout rows in one launch (``csrc/stacked.cu``, a thread
per (key, row) cell, the descriptor in the launch's parameters); its plain
version is ``StackedProbe._point_all``.

``point_probe_partitioned`` replaces
``repro/kernels/probe.py::point_probe_partitioned``, the tier of filters
above the resident budget.  On a CUDA state it is one launch of the kernel
of ``csrc/probe.cu``, one thread per key reading the state straight from
device memory up to its first clear bit, with no plan or bucketing in
torch: on Hopper the resident probe is already the design for a state in
device memory, so both tiers share it and each wrapper counts its own
launches.  Its plain version
(``point_partitioned_plain``, and the wrapper on a CPU state) keeps the
reference's steps: the engine's point plan, the probes bucketed by filter
block (``_bucket_probes``, the reference's slot layout), a torch gather and
the scatter-min per key.
"""
from __future__ import annotations

import torch

from ..core import FilterLayout
from ..core.engine import stacked_probe
from ..core.bloomrf import lanes_u32
from . import _build
from ._checks import check_keys, check_stack, check_state
from .ref import check_kernel_layout, filter_for_layout

__all__ = ["point_probe_resident", "point_probe_stacked_resident",
           "point_probe_partitioned", "point_partitioned_plain",
           "DEFAULT_TILE", "DEFAULT_BLOCK_U32"]

DEFAULT_TILE = 512           # probe slots per bucketing tile (plain version)
DEFAULT_BLOCK_U32 = 16384    # 64 KiB filter blocks (plain version)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _launch_point(layout: FilterLayout, state: torch.Tensor,
                  keys: torch.Tensor) -> torch.Tensor:
    """The verdicts from one launch of ``csrc/probe.cu``'s kernel (none for
    an empty batch); the calling wrapper counts the launch."""
    out = torch.empty(keys.shape[0], dtype=torch.bool, device=state.device)
    if keys.numel():
        desc = _build.param_descriptor(layout)
        _build.launch("bloomrf_point_probe", state.device, keys.data_ptr(),
                      keys.numel(), state.data_ptr(), desc.ctypes.data,
                      out.data_ptr())
    return out


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
    out = _launch_point(layout, state, keys)
    if keys.numel():
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
        desc = _build.param_descriptor(layout)
        _build.launch("bloomrf_point_stacked", stack.device, keys.data_ptr(),
                      keys.numel(), stack.data_ptr(), u, R, desc.ctypes.data,
                      out.data_ptr())
        point_probe_stacked_resident.launches += 1
    return out


#: kernel launches so far (a plain count; reset it by assignment)
point_probe_stacked_resident.launches = 0


# ---------------------------------------------------------------------------
# partitioned tier (filters above the resident budget)
# ---------------------------------------------------------------------------

def _bucket_probes(lane: torch.Tensor, tile: int, block_u32: int,
                   nblocks: int):
    """Bucket flat lane probes by filter block, as the reference does.

    Sorts probes by owning block (a stable sort, as ``jnp.argsort``) and
    pads each block's probe list to a tile multiple, so no tile spans two
    blocks.  Returns ``(order, slot, lane_b, tile_block, capr)``: the sort
    permutation, each sorted probe's slot, the padded ``int32`` lane table
    (-1 = padding), each tile's block (0 for an all-padding tile) and the
    padded length, the worst case ``round_up(nprobe + nblocks * tile,
    tile)`` so that no count leaves the device.  Callers place per-probe
    payloads with ``out[slot] = payload[order]``."""
    dev = lane.device
    nprobe = lane.shape[0]
    blk = lane // block_u32
    order = torch.argsort(blk, stable=True)
    lane_s, blk_s = lane[order], blk[order]
    # a count per block without a host sync (bincount on CUDA reads its
    # maximum back to size its output)
    counts = torch.zeros(nblocks, dtype=torch.int64, device=dev).index_add_(
        0, blk_s, torch.ones_like(blk_s))
    padded = (counts + tile - 1) // tile * tile
    starts = torch.cumsum(padded, 0) - padded
    rank = torch.arange(nprobe, device=dev) \
        - (torch.cumsum(counts, 0) - counts)[blk_s]
    slot = starts[blk_s] + rank
    capr = _round_up(nprobe + nblocks * tile, tile)
    lane_b = torch.full((capr,), -1, dtype=torch.int32, device=dev)
    lane_b[slot] = lane_s.to(torch.int32)
    head = lane_b[::tile]
    tile_block = torch.where(head < 0, 0, head // block_u32).to(torch.int32)
    return order, slot, lane_b, tile_block, capr


def _check_tiling(layout: FilterLayout, tile: int, block_u32: int) -> int:
    """The number of filter blocks; refuses a tile or block below 1."""
    if tile < 1 or block_u32 < 1:
        raise ValueError(f"tile and block_u32 must be >= 1, "
                         f"got {tile}, {block_u32}")
    return _round_up(layout.total_u32, block_u32) // block_u32


def gather_partitioned(state: torch.Tensor, lane_b: torch.Tensor,
                       tile_block: torch.Tensor, tile: int,
                       block_u32: int) -> torch.Tensor:
    """The plain versions' read: each real slot's lane as a uint32 value in
    int64, read at its tile's block base plus its offset in the block (as
    the reference's kernels address it); 0 at padding."""
    real = lane_b >= 0
    base = tile_block.to(torch.int64).repeat_interleave(tile)
    idx = torch.where(real, base * block_u32 + lane_b % block_u32, 0)
    return torch.where(real, lanes_u32(state, idx), 0)


def _point_buckets(layout, state, keys, tile, block_u32, nblocks):
    """The point plan bucketed by block: ``(lane_b, sh_b, key_b,
    tile_block)``, key id ``B`` (a scrap slot) at padding."""
    plan = filter_for_layout(layout, state.device).engine.plan_point(keys)
    B, P = plan.lanes.shape
    order, slot, lane_b, tile_block, capr = _bucket_probes(
        plan.lanes.reshape(-1), tile, block_u32, nblocks)
    sh_b = torch.zeros(capr, dtype=torch.int32, device=state.device)
    sh_b[slot] = plan.sh.reshape(-1)[order].to(torch.int32)
    key_b = torch.full((capr,), B, dtype=torch.int32, device=state.device)
    key_b[slot] = (order // P).to(torch.int32)
    return lane_b, sh_b, key_b, tile_block


def point_partitioned_bits(state, lane_b, sh_b, key_b, tile_block, B: int,
                           tile: int, block_u32: int) -> torch.Tensor:
    """``bool[B]`` verdicts from bucketed point probes, by a torch gather:
    every key starts present and a probe whose bit is 0 clears its key."""
    acc = torch.ones(B + 1, dtype=torch.uint8, device=state.device)
    bits = (gather_partitioned(state, lane_b, tile_block, tile, block_u32)
            >> sh_b) & 1
    acc[key_b[(lane_b >= 0) & (bits == 0)].to(torch.int64)] = 0
    return acc[:B] != 0


def _check_point_partitioned(layout, state, keys, tile, block_u32) -> int:
    check_kernel_layout(layout)
    check_state(layout, state)
    check_keys("keys", keys, state.device)
    return _check_tiling(layout, tile, block_u32)


def _point_plain(layout, state, keys, tile, block_u32, nblocks):
    if not keys.numel():
        return torch.zeros(0, dtype=torch.bool, device=state.device)
    buckets = _point_buckets(layout, state, keys, tile, block_u32, nblocks)
    return point_partitioned_bits(state, *buckets, keys.shape[0], tile,
                                  block_u32)


def point_probe_partitioned(layout: FilterLayout, state: torch.Tensor,
                            keys: torch.Tensor, tile: int = DEFAULT_TILE,
                            block_u32: int = DEFAULT_BLOCK_U32
                            ) -> torch.Tensor:
    """``bool[B]`` point verdicts for ``keys`` (int64 carriers of uint32
    codes) against ``state`` (int32 lanes) of a filter of any size: one
    kernel launch on a CUDA state, which ignores ``tile`` and ``block_u32``
    (the reference's tiling, still validated); the plain version on a CPU
    state."""
    nblocks = _check_point_partitioned(layout, state, keys, tile, block_u32)
    if state.device.type == "cpu":
        return _point_plain(layout, state, keys, tile, block_u32, nblocks)
    out = _launch_point(layout, state, keys)
    if keys.numel():
        point_probe_partitioned.launches += 1
    return out


def point_partitioned_plain(layout: FilterLayout, state: torch.Tensor,
                            keys: torch.Tensor, tile: int = DEFAULT_TILE,
                            block_u32: int = DEFAULT_BLOCK_U32
                            ) -> torch.Tensor:
    """The plain version of :func:`point_probe_partitioned` on any device:
    the reference's plan and bucketing, the read as a torch gather."""
    nblocks = _check_point_partitioned(layout, state, keys, tile, block_u32)
    return _point_plain(layout, state, keys, tile, block_u32, nblocks)


#: kernel launches so far (a plain count; reset it by assignment)
point_probe_partitioned.launches = 0
