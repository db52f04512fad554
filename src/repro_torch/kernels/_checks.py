"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

from ..core import FilterLayout

#: rows of a stack: the kernels' second grid dimension
MAX_ROWS = 65535


def check_state(layout: FilterLayout, state: torch.Tensor) -> None:
    """A kernel wrapper takes the plain path on the CPU, launches on CUDA,
    and refuses any other device."""
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bloomRF kernel for device {state.device}")
    if state.dtype != torch.int32 or state.dim() != 1 \
            or state.shape[0] != layout.total_u32 or not state.is_contiguous():
        raise ValueError(
            f"state must be a contiguous int32[{layout.total_u32}] tensor "
            f"(uint32 lanes), got {state.dtype}{list(state.shape)}")


def check_stack(layout: FilterLayout, stack: torch.Tensor) -> None:
    """A stack of ``R`` same-layout rows: ``int32[R, total_u32]``."""
    if stack.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bloomRF kernel for device {stack.device}")
    if stack.dtype != torch.int32 or stack.dim() != 2 \
            or stack.shape[1] != layout.total_u32 or stack.shape[0] < 1 \
            or not stack.is_contiguous():
        raise ValueError(
            f"stack must be a contiguous int32[R, {layout.total_u32}] tensor "
            f"(uint32 lanes), got {stack.dtype}{list(stack.shape)}")
    if stack.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} stacked rows, "
                         f"got {stack.shape[0]}")


def check_keys(name: str, keys: torch.Tensor, device: torch.device) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-d int64 tensor of "
                         f"uint32 key codes, got {keys.dtype}"
                         f"{list(keys.shape)}")
    if keys.device != device:
        raise ValueError(f"{name} lie on {keys.device}, the state on {device}")

