"""Datatype support (paper §8): order-preserving codecs into integer domains.

* Floating point: the monotone map φ — flip all bits for negatives, set the
  sign bit for positives — makes the uint order match the float order.
* Variable-length strings: 7 most-significant bytes carry the first 7 chars;
  the least-significant byte carries an 8-bit hash of the full string
  (including its length).  Point queries use the full code; range bounds use
  0x00 / 0xFF tails.
* Multi-attribute: two reduced-precision (32-bit) attributes concatenated in
  both orders; conjunctive point/range predicates map to range queries over
  one of the two concatenations.

A numpy-only copy of ``repro/core/codecs.py``: the port keeps its own so
that it never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "float64_to_u64",
    "u64_to_float64",
    "float32_to_u32",
    "u32_to_float32",
    "string_point_code",
    "string_range_bounds",
    "pack2",
    "unpack2",
    "pack2x32",
    "unpack2x32",
    "multiattr_insert_codes",
    "multiattr_range_for_a_eq_b_range",
]


def float64_to_u64(x) -> np.ndarray:
    """Monotone coding: x < y  <=>  code(x) < code(y) (paper's φ)."""
    b = np.asarray(x, np.float64).view(np.uint64)
    sign = (b >> np.uint64(63)) != 0
    return np.where(sign, ~b, b | np.uint64(1 << 63))


def u64_to_float64(c) -> np.ndarray:
    c = np.asarray(c, np.uint64)
    sign = (c >> np.uint64(63)) == 0
    return np.where(sign, ~c, c & ~np.uint64(1 << 63)).view(np.float64)


def float32_to_u32(x) -> np.ndarray:
    b = np.asarray(x, np.float32).view(np.uint32)
    sign = (b >> np.uint32(31)) != 0
    return np.where(sign, ~b, b | np.uint32(1 << 31))


def u32_to_float32(c) -> np.ndarray:
    c = np.asarray(c, np.uint32)
    sign = (c >> np.uint32(31)) == 0
    return np.where(sign, ~c, c & ~np.uint32(1 << 31)).view(np.float32)


def _str_tail_hash(s: bytes) -> int:
    h = 0x9E
    for ch in s + bytes([len(s) & 0xFF]):
        h = ((h * 131) ^ ch) & 0xFF
    return h


def string_point_code(s: str | bytes) -> int:
    """SuRF-Hash-style: 7-byte prefix + 1-byte tail hash (paper §8)."""
    b = s.encode() if isinstance(s, str) else s
    prefix = b[:7].ljust(7, b"\x00")
    code = int.from_bytes(prefix, "big") << 8
    return code | _str_tail_hash(b)


def string_range_bounds(lo: str | bytes, hi: str | bytes) -> tuple:
    """Range endpoints on the 7-byte prefix: tail 0x00 below, 0xFF above."""
    bl = (lo.encode() if isinstance(lo, str) else lo)[:7].ljust(7, b"\x00")
    bh = (hi.encode() if isinstance(hi, str) else hi)[:7].ljust(7, b"\x00")
    return (int.from_bytes(bl, "big") << 8,
            (int.from_bytes(bh, "big") << 8) | 0xFF)


def pack2(a, b, b_bits: int) -> np.ndarray:
    """Order-preserving concatenation ``<A,B>`` with a ``b_bits``-wide low
    field: ``(a, b) < (a', b')`` lexicographically  <=>  code < code'.
    Generalises :func:`pack2x32`; the serve layer packs (session, chunk)
    keys through this with ``b_bits=16``."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    return (a << np.uint64(b_bits)) | (b & np.uint64((1 << b_bits) - 1))


def unpack2(code, b_bits: int) -> tuple:
    code = np.asarray(code, np.uint64)
    return code >> np.uint64(b_bits), code & np.uint64((1 << b_bits) - 1)


def pack2x32(a, b) -> np.ndarray:
    """Concatenate two (reduced-precision) 32-bit attributes into a u64 key."""
    return pack2(a, b, 32)


def unpack2x32(code) -> tuple:
    """Split a :func:`pack2x32` code back into its (a, b) attributes."""
    return unpack2(code, 32)


def multiattr_insert_codes(a, b) -> tuple:
    """Insert both <A,B> and <B,A> (paper §8)."""
    return pack2x32(a, b), pack2x32(b, a)


def multiattr_range_for_a_eq_b_range(a_const, b_lo, b_hi) -> tuple:
    """Range [lo,hi] answering ``A == a_const AND B in [b_lo, b_hi]`` against
    the <A,B> concatenation (use the <B,A> codes for the mirrored predicate)."""
    return (pack2x32(a_const, b_lo), pack2x32(a_const, b_hi))
