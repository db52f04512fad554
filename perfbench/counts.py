"""The work of each operation, in bytes, for the kernels' roofline.

The count is of the work, not of what the program moves, and uses the
benchmark's own copy of the layout and hashing (the configuration's
reference module, ``reference/bloomrf.py`` by default):

* each key or bound counts at its domain's width (4 bytes for 32-bit
  keys), whatever integer type holds it;
* each verdict counts one byte;
* the state counts the distinct 32-byte sectors the batch's answers need,
  once per batch: for a point, its positions (bottom layer first) up to
  and including its first clear bit; for a range, the words the range plan
  reads until its verdict is decided; for an insert, every sector it sets
  a bit in, read and written.

A kernel that reads less, or takes narrower keys, therefore shows a higher
share of the same yardstick.
"""
from __future__ import annotations

import torch

from .reference import bloomrf

__all__ = ["SECTOR_BYTES", "point_bytes", "range_bytes", "insert_bytes",
           "batch_bytes"]

SECTOR_BYTES = 32
_SECTOR_SHIFT = 8          # bits in a sector: 2^8


def _key_bytes(lay) -> int:
    return (lay.d + 7) // 8


def _distinct(sectors: list) -> int:
    return torch.unique(torch.cat(sectors)).numel() if sectors else 0


def point_bytes(lay, state: torch.Tensor, keys: torch.Tensor,
                ref=bloomrf) -> int:
    pos = ref.positions(lay, keys)
    clear = (((state[pos >> 5].to(torch.int64) & ref.MASK32)
              >> (pos & 31)) & 1) == 0
    earlier = torch.cumsum(clear.to(torch.int32), dim=1) - clear.to(
        torch.int32)
    need = pos[earlier == 0] >> _SECTOR_SHIFT
    return keys.numel() * (_key_bytes(lay) + 1) \
        + SECTOR_BYTES * _distinct([need])


def range_bytes(lay, state: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, ref=bloomrf) -> int:
    sectors = []

    def on_read(i, wordkey, need):
        for rep in range(lay.replicas[i]):
            bit = ref.word_bit(lay, i, rep, wordkey[need])
            sectors.append(bit >> _SECTOR_SHIFT)

    ref.range_verdicts(lay, state, lo, hi, on_read=on_read)
    return lo.numel() * (2 * _key_bytes(lay) + 1) \
        + SECTOR_BYTES * _distinct(sectors)


def insert_bytes(lay, keys: torch.Tensor, ref=bloomrf) -> int:
    sectors = ref.positions(lay, keys).reshape(-1) >> _SECTOR_SHIFT
    return keys.numel() * _key_bytes(lay) \
        + 2 * SECTOR_BYTES * _distinct([sectors])


def batch_bytes(lay, state: torch.Tensor, batch, ref=bloomrf) -> int:
    """The work of one pool entry (``traffic.Batch``) against ``state``,
    the reference's state of the probed keys (unused by an insert)."""
    if batch.kind == "point":
        return point_bytes(lay, state, batch.keys, ref)
    if batch.kind == "range":
        return range_bytes(lay, state, batch.lo, batch.hi, ref)
    return insert_bytes(lay, batch.keys, ref)
