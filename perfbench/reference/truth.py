"""Exact answers from the sorted keys: what a filter approximates.

A point is present iff it equals a key; a range ``[lo, hi]`` (bounds in
either order) is non-empty iff some key lies in it.  Both come from a
binary search of the sorted keys, on the keys' device.
"""
from __future__ import annotations

import torch

__all__ = ["sort_keys", "point_truth", "range_truth"]


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    """The keys as sorted int64 values."""
    return torch.sort(keys.to(torch.int64)).values


def _first_at_or_above(sorted_keys: torch.Tensor, q: torch.Tensor):
    """The least key ``>= q`` (and whether there is one)."""
    idx = torch.searchsorted(sorted_keys, q)
    found = idx < sorted_keys.numel()
    return sorted_keys[idx.clamp(max=sorted_keys.numel() - 1)], found


def point_truth(sorted_keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    key, found = _first_at_or_above(sorted_keys, q.to(torch.int64))
    return found & (key == q)


def range_truth(sorted_keys: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    key, found = _first_at_or_above(sorted_keys, torch.minimum(lo, hi))
    return found & (key <= torch.maximum(lo, hi))
