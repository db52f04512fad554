"""Unsigned 64-bit arithmetic on ``int64`` carriers.

Keys of a 64-bit domain (and every prefix, bound and hash derived from
them) travel as ``int64`` tensors holding the uint64 bits unchanged: a
value of ``2**63`` or more reads as negative.  Adds, subtracts, multiplies,
``^``, ``&``, ``|`` and ``<<`` already wrap modulo ``2**64`` exactly as
the reference's uint64 arithmetic does; what differs is the signed order,
the arithmetic right shift and the signed ``%``.  This module holds those
three, and nothing else of the port does them on carriers:

* compare, min, max and clamp in the unsigned order, by flipping the sign
  bit (``x ^ -2**63``), which maps that order onto the signed one;
* the logical right shift, a shift by 64 or more giving 0;
* ``h % n`` for ``1 <= n < 2**31``, reducing the high and low 32-bit
  halves in turn so that no intermediate overflows.

``torch.uint64`` is not used: on the CPU it lacks ``>>``, ``%``, compares,
``minimum``, ``clamp``, ``index_add_`` and compare-based ``where``.  Values
below ``2**63`` (every 32-bit code) give the same results under these
functions as under the signed ones.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["SIGN", "signed", "carrier", "le", "ge", "minimum", "maximum",
           "clamp", "shr", "mod"]

#: the sign bit of an int64 carrier
SIGN = -(1 << 63)
_MASK32 = 0xFFFFFFFF


def signed(v: int) -> int:
    """A uint64 Python int as the int64 value with the same bits."""
    v = int(v) & ((1 << 64) - 1)
    return v - (1 << 64) if v >> 63 else v


def carrier(a, device=None) -> torch.Tensor:
    """Host uint codes (any integer array-like, each in ``[0, 2**64)``) as
    an int64 carrier tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(a, np.uint64).view(np.int64))
    return torch.from_numpy(arr).to(device)


def _flip(x):
    return x ^ SIGN if isinstance(x, torch.Tensor) else signed(x) ^ SIGN


def le(a, b) -> torch.Tensor:
    return _flip(a) <= _flip(b)


def ge(a, b) -> torch.Tensor:
    return _flip(a) >= _flip(b)


def minimum(a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(le(a, b), a, b)


def maximum(a: torch.Tensor, b) -> torch.Tensor:
    return torch.where(ge(a, b), a, b)


def clamp(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``min(max(x, lo), hi)`` in the unsigned order (``jnp.clip``'s)."""
    return minimum(maximum(x, lo), hi)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """The logical right shift ``x >> s`` of uint64 bits; 0 for ``s >= 64``."""
    if s >= 64:
        return torch.zeros_like(x)
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h % n`` of uint64 bits for ``1 <= n < 2**31``: with ``h = hi *
    2**32 + lo``, ``((hi % n) * 2**32 + lo) % n``, every step below
    ``2**63``."""
    if not 1 <= n < 1 << 31:
        raise ValueError(f"modulus {n} outside [1, 2**31)")
    return (((shr(h, 32) % n) << 32) | (h & _MASK32)) % n
