"""Compression for the training substrate and filter-state snapshots.

Counterpart of ``repro/dist/compression.py``.  Two codecs live here:

* **int8 error-feedback** (``ef_init`` / ``ef_compress``) -- per-leaf
  symmetric int8 quantization of gradients with an error-feedback
  accumulator (Seide et al. / Karimireddy et al.): the quantization
  residual is carried into the next step, so compressed SGD keeps the
  uncompressed fixed points.  Torch ops on the gradients' device, used by
  ``train/train_loop.py`` when ``TrainConfig.grad_compression`` is set.
  ``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
  values and the residual are the reference's.

* **Elias-Fano** (``elias_fano_encode`` / ``elias_fano_decode``), copied
  (numpy only) -- the classic quasi-succinct encoding of a sorted integer
  list over a universe ``u``: low ``l = floor(log2(u/n))`` bits stored
  verbatim, high bits unary-coded in a bitmap of ``n + (u >> l)`` bits,
  ``n * (2 + log2(u/n))`` bits in all.  Run snapshots use it twice: for
  the run's sorted keys, and for its filter's set-bit positions
  (``pack_filter_state``: the set bits of a filter are a sorted posting
  list over ``total_bits``).  Both packages write the same encodings, so a
  snapshot written by either restores in the other.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["ef_init", "ef_compress", "elias_fano_encode", "elias_fano_decode",
           "elias_fano_size_bits", "pack_filter_state", "unpack_filter_state"]


# ---------------------------------------------------------------------------
# int8 error-feedback gradient compression
# ---------------------------------------------------------------------------

def ef_init(params):
    """Zero error-feedback accumulators, one f32 leaf per parameter leaf
    (on the leaf's device)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quantize_leaf(g, e):
    t = g.float() + e
    scale = torch.clamp(t.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(t / scale), -127.0, 127.0).to(torch.int8)
    deq = q.float() * scale
    return deq, t - deq


def ef_compress(grads, error):
    """Quantize ``grads + error`` to int8 per leaf; return (dequantized
    gradients, new error).  8.25 bits/value on the wire (int8 + one f32
    scale per leaf); the dequantized form keeps the train step's math
    dtype-stable."""
    g_leaves, e_leaves = tree_leaves(grads), tree_leaves(error)
    if len(g_leaves) != len(e_leaves):
        raise ValueError("grads/error tree mismatch")
    outs = iter([_quantize_leaf(g, e) for g, e in zip(g_leaves, e_leaves)])
    pairs = tree_map(lambda _: next(outs), grads)
    return (tree_map(lambda _, o: o[0], grads, pairs),
            tree_map(lambda _, o: o[1], grads, pairs))


# ---------------------------------------------------------------------------
# Elias-Fano posting lists
# ---------------------------------------------------------------------------

def _low_bits(u: int, n: int) -> int:
    if n <= 0 or u <= n:
        return 0
    return max(int(math.floor(math.log2(u / n))), 0)


def elias_fano_encode(values, universe: Optional[int] = None) -> dict:
    """Encode a sorted (non-decreasing) uint64 list over ``[0, universe)``."""
    v = np.asarray(values, np.uint64)
    if v.ndim != 1:
        raise ValueError("elias_fano_encode takes a 1-D sorted list")
    n = len(v)
    if n and (v[1:] < v[:-1]).any():
        raise ValueError("elias_fano_encode requires a sorted list")
    u = int(universe) if universe is not None else (int(v[-1]) + 1 if n else 1)
    if n and int(v[-1]) >= u:
        raise ValueError(f"value {int(v[-1])} outside universe {u}")
    if n == 0:  # decode never reads the buffers; don't size them by u
        return {"n": 0, "u": u, "l": 0, "low": np.zeros(0, np.uint8),
                "high": np.zeros(0, np.uint8)}
    lbits = _low_bits(u, n)
    # low halves: n * lbits bits, packed little-endian-by-value
    if lbits:
        shifts = np.arange(lbits, dtype=np.uint64)
        low_bits = ((v[:, None] >> shifts[None, :]) & np.uint64(1)
                    ).astype(np.uint8).reshape(-1)
        low = np.packbits(low_bits)
    else:
        low = np.zeros(0, np.uint8)
    # high halves: unary gaps -> bit i+high[i] set, i = 0..n-1
    hi_len = n + (u >> lbits) + 1
    hi_bits = np.zeros(hi_len, np.uint8)
    if n:
        hi_bits[(v >> np.uint64(lbits)).astype(np.int64) + np.arange(n)] = 1
    return {"n": n, "u": u, "l": lbits, "low": low,
            "high": np.packbits(hi_bits)}


def elias_fano_decode(enc: dict) -> np.ndarray:
    """Inverse of :func:`elias_fano_encode`; returns the sorted uint64 list."""
    n, u, lbits = enc["n"], enc["u"], enc["l"]
    if n == 0:
        return np.zeros(0, np.uint64)
    hi_bits = np.unpackbits(enc["high"])
    ones = np.flatnonzero(hi_bits)[:n]
    high = (ones - np.arange(n)).astype(np.uint64)
    if lbits:
        low_bits = np.unpackbits(enc["low"])[: n * lbits].reshape(n, lbits)
        shifts = np.arange(lbits, dtype=np.uint64)
        low = (low_bits.astype(np.uint64) << shifts[None, :]).sum(
            axis=1, dtype=np.uint64)
    else:
        low = np.zeros(n, np.uint64)
    return (high << np.uint64(lbits)) | low


def elias_fano_size_bits(enc: dict) -> int:
    """Encoded size (payload bits, excluding the 3-int header)."""
    return 8 * (len(enc["low"]) + len(enc["high"]))


# ---------------------------------------------------------------------------
# filter-state snapshots
# ---------------------------------------------------------------------------

def pack_filter_state(state_u32) -> dict:
    """EF-encode the set-bit positions of a packed uint32 filter state.

    bloomRF states are sparse early in their fill curve (bits_per_key * n set
    bits out of total_bits), so the posting list beats the raw bitmap until
    the filter approaches half full."""
    lanes = np.asarray(state_u32, np.uint32)
    if lanes.ndim != 1:
        raise ValueError("expected a flat uint32 lane vector")
    shifts = np.arange(32, dtype=np.uint32)
    bits = ((lanes[:, None] >> shifts[None, :]) & np.uint32(1)).astype(bool)
    positions = np.flatnonzero(bits.reshape(-1)).astype(np.uint64)
    return elias_fano_encode(positions, universe=32 * len(lanes))


def unpack_filter_state(enc: dict, total_u32: int) -> np.ndarray:
    """Inverse of :func:`pack_filter_state` -> uint32[total_u32]."""
    pos = elias_fano_decode(enc)
    buf = np.zeros(total_u32, np.uint32)
    np.bitwise_or.at(buf, (pos >> np.uint64(5)).astype(np.int64),
                     np.uint32(1) << (pos & np.uint64(31)).astype(np.uint32))
    return buf
