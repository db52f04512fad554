"""Hash functions for bloomRF, on PyTorch int64 carriers.

Counterpart of ``repro/core/hashing.py``.  Key codes travel as ``int64``
tensors: a ``d <= 32`` domain's hold the uint32 value, a ``d <= 64``
domain's the uint64 bits (``core/uint64.py``), because PyTorch's CPU build
lacks ``>>``, ``%`` and compares on its unsigned dtypes.  ``mix32``
reduces every multiply to 32 bits without overflowing int64; ``mix64``
lets the int64 multiplies wrap modulo ``2**64`` and shifts logically.
Both equal the reference's arithmetic bit for bit on any device.  The CUDA
kernels compute ``mix32`` in ``csrc/bloomrf.cuh`` (they take ``d <= 32``
only, as the reference's do).
"""
from __future__ import annotations

import numpy as np
import torch

from . import uint64 as u64

__all__ = [
    "splitmix64_np",
    "derive_seeds",
    "dyadic_prefixes",
    "mix64",
    "mix32",
    "mix",
    "key_dtype_for",
]

_U64 = np.uint64
MASK32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# Host-side (numpy) seed derivation
# ---------------------------------------------------------------------------

def splitmix64_np(state: int) -> tuple[int, int]:
    """One splitmix64 step on python ints. Returns (new_state, output)."""
    mask = (1 << 64) - 1
    state = (state + 0x9E3779B97F4A7C15) & mask
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
    z = z ^ (z >> 31)
    return state, z


def derive_seeds(base_seed: int, n: int) -> np.ndarray:
    """Derive ``n`` decorrelated 64-bit seeds from a base seed (host side)."""
    out = np.empty(n, dtype=_U64)
    s = base_seed & ((1 << 64) - 1)
    for i in range(n):
        s, z = splitmix64_np(s)
        out[i] = _U64(z)
    return out


# ---------------------------------------------------------------------------
# Device-side mixing on int64 carriers
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``0 <= x < 2**32`` without int64 overflow:
    the constant is split into 16-bit halves so every partial product stays
    below 2**49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style 32-bit finalizer on uint32 values held in int64."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


_MIX64_C1 = u64.signed(0xBF58476D1CE4E5B9)
_MIX64_C2 = u64.signed(0x94D049BB133111EB)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on uint64 bits held in int64 (wrapping
    multiplies, logical shifts)."""
    x = (x ^ u64.shr(x, 30)) * _MIX64_C1
    x = (x ^ u64.shr(x, 27)) * _MIX64_C2
    return x ^ u64.shr(x, 31)


def mix(x: torch.Tensor, seed, key_bits: int) -> torch.Tensor:
    """Seeded finalizer in the key width: ``mix64`` of the key xor the
    64-bit seed above 32 bits, else ``mix32`` with the seed cut to 32."""
    if key_bits > 32:
        return mix64(x ^ u64.signed(seed))
    return mix32((x & MASK32) ^ (int(seed) & MASK32))


def key_dtype_for(d: int) -> torch.dtype:
    """Carrier dtype for a d-bit domain: int64, holding the uint32 value
    (d <= 32) or the uint64 bits (d <= 64)."""
    if d <= 64:
        return torch.int64
    raise ValueError(f"domain bits must be <= 64, got {d}")


def dyadic_prefixes(keys: torch.Tensor, level: int, d: int) -> torch.Tensor:
    """Dyadic prefixes of ``keys`` at ``level``: the keys with their low
    ``level`` bits dropped, living in the ``d - level``-bit prefix domain.

    A key ``k`` is in ``[lo, hi]`` only if ``k >> level`` is in
    ``[lo >> level, hi >> level]``."""
    if not (0 <= level < d):
        raise ValueError(f"need 0 <= level < d, got level={level}, d={d}")
    key_dtype_for(d)
    keys = torch.as_tensor(keys, dtype=torch.int64)
    if d <= 32:
        return (keys & MASK32) >> level
    return u64.shr(keys, level)
