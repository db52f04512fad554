"""Dynamic-filter machinery: deletion, aging, and in-place capacity growth.

Counterpart of ``repro/core/dynamic.py``.  Three mechanisms layered on the
flat ``int32[total_u32]`` lane state (the reference's uint32 bits), none of
which touches the probe path: the probed bitmap stays one plain lane
vector, so the kernels and the engine serve every case.

* **Counting lanes** (:class:`CountingLanes`, :class:`DeletableBloomRF`) —
  a host-side ``uint8`` counter per bit beside the probed bitmap.  Deleting
  a previously inserted key decrements its positions; a counter that
  reaches zero clears its bit (:func:`clear_bits`).  Counters saturate at
  255 and freeze: a frozen bit is never cleared (a little FPR, never a
  false negative).
* **Generation lanes** (:class:`Generations`) — TTL as ``G`` copies of the
  state.  Inserts land in the current one; probes read the OR of all of
  them (bloomRF state is union-closed under one layout).  ``advance()``
  zeroes the oldest, so expired keys stop costing false positives.
* **In-place capacity promotion** (:func:`promotion_factors`,
  :func:`promote_layout`, :func:`promote_state`) — grow a filter by tiling
  each hashed segment an integer number of times.  A layer's word index is
  ``h % nwords`` and ``(h mod f*N) mod N == h mod N``, so every old bit
  lands among its ``f`` copies exactly where the new layout hashes it:
  zero false negatives, with no access to the keys.

Counters stay host numpy, as in the reference; state operations are torch
ops on the state's device.
"""
from __future__ import annotations

import dataclasses
from functools import reduce
from typing import Callable, List, Optional

import numpy as np
import torch

from .layout import FilterLayout

__all__ = [
    "promotion_factors",
    "promote_layout",
    "promote_state",
    "promote_counts",
    "clear_bits",
    "CountingLanes",
    "Generations",
    "DeletableBloomRF",
]


# ---------------------------------------------------------------------------
# in-place capacity promotion
# ---------------------------------------------------------------------------

def promotion_factors(old: FilterLayout,
                      new: FilterLayout) -> Optional[tuple]:
    """Per-segment tiling factors promoting ``old`` state to ``new``, or
    ``None`` when the pair is not promotion-compatible: the same domain and
    seed, ``new`` keeps a prefix of the old layers (deltas, replicas,
    segment assignment) with the same widest replica count, and each
    segment's new allocation is an integer multiple of the old one (an
    exact-bitmap segment is identity-mapped: factor 1, same top level)."""
    if old.d != new.d or old.seed != new.seed:
        return None
    if new.k > old.k:
        return None
    if new.deltas != old.deltas[:new.k]:
        return None
    if new.replicas != old.replicas[:new.k]:
        return None
    if new.seg_of_layer != old.seg_of_layer[:new.k]:
        return None
    if max(old.replicas) != max(new.replicas):
        # seed tables reshape to (k, rmax); a different rmax scrambles rows
        return None
    if len(new.seg_bits) != len(old.seg_bits):
        return None
    if old.exact_seg != new.exact_seg:
        return None
    factors = []
    for s in range(len(old.seg_bits)):
        ob = old.seg_alloc_bits[s]
        nb = new.seg_alloc_bits[s]
        if nb % ob != 0:
            return None
        f = nb // ob
        if old.exact_seg is not None and s == old.exact_seg:
            if f != 1 or old.top_level != new.top_level:
                return None
        factors.append(f)
    return tuple(factors)


def promote_layout(layout: FilterLayout, factor: int = 4) -> FilterLayout:
    """The always-promotable growth target: the same layers, every hashed
    segment's allocation scaled by ``factor`` (exact segments keep their
    size), so ``promotion_factors`` on the pair gives ``(factor, ...)``."""
    if factor < 1:
        raise ValueError(f"promotion factor must be >= 1, got {factor}")
    seg_bits = []
    for s, alloc in enumerate(layout.seg_alloc_bits):
        if layout.exact_seg is not None and s == layout.exact_seg:
            seg_bits.append(layout.seg_bits[s])
        else:
            seg_bits.append(alloc * factor)
    return dataclasses.replace(layout, seg_bits=tuple(seg_bits))


def _factors(old: FilterLayout, new: FilterLayout) -> tuple:
    factors = promotion_factors(old, new)
    if factors is None:
        raise ValueError("layouts are not promotion-compatible")
    return factors


def promote_state(state: torch.Tensor, old: FilterLayout,
                  new: FilterLayout) -> torch.Tensor:
    """Map lane state from ``old`` to ``new`` by segment tiling, on the
    state's device; leading batch dimensions are kept.  Raises
    ``ValueError`` for an incompatible pair."""
    factors = _factors(old, new)
    if state.shape[-1] != old.total_u32:
        raise ValueError(
            f"state has {state.shape[-1]} lanes, old layout {old.total_u32}")
    out = torch.zeros(state.shape[:-1] + (new.total_u32,), dtype=state.dtype,
                      device=state.device)
    for s, f in enumerate(factors):
        o_lo, o_n = old.seg_off_bits[s] // 32, old.seg_alloc_bits[s] // 32
        n_lo, n_n = new.seg_off_bits[s] // 32, new.seg_alloc_bits[s] // 32
        reps = (1,) * (state.dim() - 1) + (f,)
        out[..., n_lo:n_lo + n_n] = state[..., o_lo:o_lo + o_n].repeat(*reps)
    return out


def promote_counts(counts: np.ndarray, old: FilterLayout,
                   new: FilterLayout) -> np.ndarray:
    """Tile counting lanes alongside :func:`promote_state`: each copy
    inherits the full counter (a key's position resolves to one copy; the
    others decay into the same junk bits the state tiling makes)."""
    factors = _factors(old, new)
    out = np.zeros(new.total_bits, np.uint8)
    for s, f in enumerate(factors):
        o_lo, o_n = old.seg_off_bits[s], old.seg_alloc_bits[s]
        n_lo = new.seg_off_bits[s]
        out[n_lo:n_lo + o_n * f] = np.tile(counts[o_lo:o_lo + o_n], f)
    return out


# ---------------------------------------------------------------------------
# bit clearing + counting lanes (deletable filters)
# ---------------------------------------------------------------------------

def clear_bits(state: torch.Tensor, pos) -> torch.Tensor:
    """Clear the given bit positions of packed lane state: the mask is
    built on the host, as in the reference, and ANDed on the state's
    device.  Returns a new state (``state`` itself when ``pos`` is
    empty)."""
    pos = np.asarray(pos, np.int64).reshape(-1)
    if pos.size == 0:
        return state
    mask = np.zeros(state.shape[-1], np.uint32)
    np.bitwise_or.at(mask, pos >> 5,
                     np.uint32(1) << (pos & 31).astype(np.uint32))
    keep = torch.from_numpy((~mask).view(np.int32)).to(state.device)
    return state & keep


class CountingLanes:
    """Host-side ``uint8`` reference counters, one per filter bit.

    Counters saturate at :attr:`SATURATE` and freeze there: a saturated
    counter is never decremented and its bit is never cleared."""

    SATURATE = 255

    __slots__ = ("counts",)

    def __init__(self, total_bits: int, counts: Optional[np.ndarray] = None):
        if counts is not None:
            counts = np.asarray(counts, np.uint8)
            if counts.shape != (total_bits,):
                raise ValueError("counter/total_bits shape mismatch")
            self.counts = counts.copy()
        else:
            self.counts = np.zeros(total_bits, np.uint8)

    def add(self, pos) -> None:
        """Count one contribution per occurrence in ``pos``."""
        pos = np.asarray(pos, np.int64).reshape(-1)
        if pos.size == 0:
            return
        upos, cnt = np.unique(pos, return_counts=True)
        cur = self.counts[upos].astype(np.int64)
        self.counts[upos] = np.minimum(cur + cnt,
                                       self.SATURATE).astype(np.uint8)

    def remove(self, pos) -> np.ndarray:
        """Decrement contributions; return the positions that drained to
        zero (whose bits the caller may clear).  Saturated counters stay."""
        pos = np.asarray(pos, np.int64).reshape(-1)
        if pos.size == 0:
            return pos
        upos, cnt = np.unique(pos, return_counts=True)
        cur = self.counts[upos].astype(np.int64)
        frozen = cur >= self.SATURATE
        new = np.maximum(cur - cnt, 0)
        new[frozen] = self.SATURATE
        self.counts[upos] = new.astype(np.uint8)
        return upos[(new == 0) & (cur > 0)]

    def promoted(self, old: FilterLayout, new: FilterLayout) -> "CountingLanes":
        return CountingLanes(new.total_bits,
                             counts=promote_counts(self.counts, old, new))


# ---------------------------------------------------------------------------
# generation lanes (TTL / aging)
# ---------------------------------------------------------------------------

def _or_states(a, b):
    """Lane-wise OR of two states: tensors, or tuples of tensors."""
    if isinstance(a, tuple):
        return tuple(_or_states(x, y) for x, y in zip(a, b))
    return torch.bitwise_or(a, b)


class Generations:
    """``G`` OR-composable copies of a lane state (a tensor, or a tuple of
    tensors such as a tenant bank's ``(state, meta)``) giving sweep-free
    TTL.

    Inserts go to the current generation; probes read :attr:`collapsed`,
    the OR of all generations.  :meth:`advance` rotates to the next slot
    and zeroes it: a key inserted into the current generation is dropped
    by the ``n_generations``-th later advance, and probing absent after
    that is the contract, not a false negative."""

    __slots__ = ("zero_fn", "gens", "current", "_collapsed", "advances")

    def __init__(self, zero_fn: Callable[[], torch.Tensor],
                 n_generations: int = 4):
        if n_generations < 2:
            raise ValueError(
                f"need >= 2 generations for aging, got {n_generations}")
        self.zero_fn = zero_fn
        self.gens: List = [zero_fn() for _ in range(n_generations)]
        self.current = 0
        self.advances = 0
        self._collapsed = None

    @property
    def n_generations(self) -> int:
        return len(self.gens)

    def insert(self, fn: Callable, *args) -> None:
        """Apply ``fn(current_state, *args) -> new_state`` to the current
        generation."""
        self.gens[self.current] = fn(self.gens[self.current], *args)
        self._collapsed = None

    @property
    def collapsed(self) -> torch.Tensor:
        """OR of all generations: the state every probe reads."""
        if self._collapsed is None:
            self._collapsed = reduce(_or_states, self.gens)
        return self._collapsed

    def advance(self) -> None:
        """Retire the oldest generation (zero it) and make it current."""
        self.current = (self.current + 1) % len(self.gens)
        self.gens[self.current] = self.zero_fn()
        self.advances += 1
        self._collapsed = None

    def map(self, fn: Callable,
            zero_fn: Optional[Callable] = None) -> "Generations":
        """Rebuild with ``fn`` applied to every generation (e.g. promotion);
        pass the new shape's ``zero_fn`` whenever ``fn`` changes it."""
        out = Generations.__new__(Generations)
        out.zero_fn = zero_fn if zero_fn is not None else self.zero_fn
        out.gens = [fn(g) for g in self.gens]
        out.current = self.current
        out.advances = self.advances
        out._collapsed = None
        return out


# ---------------------------------------------------------------------------
# deletable filter over BloomRF
# ---------------------------------------------------------------------------

class DeletableBloomRF:
    """BloomRF plus counting lanes: ``delete`` of previously inserted keys.

    ``point``/``range`` delegate unchanged.  Deleting a key that was never
    inserted (or more often than inserted) is a contract violation, as with
    any counting Bloom filter."""

    def __init__(self, layout: FilterLayout, device=None):
        from .bloomrf import BloomRF

        self.layout = layout
        self.filter = BloomRF(layout, device=device)
        self.counts = CountingLanes(layout.total_bits)

    def init_state(self) -> torch.Tensor:
        return self.filter.init_state()

    def _positions(self, keys) -> np.ndarray:
        return self.filter.positions(keys).cpu().numpy().reshape(-1)

    def insert(self, state: torch.Tensor, keys) -> torch.Tensor:
        pos = self.filter.positions(keys)
        self.counts.add(pos.cpu().numpy())
        return self.filter.scatter_or(state, pos)

    def delete(self, state: torch.Tensor, keys) -> torch.Tensor:
        zeroed = self.counts.remove(self._positions(keys))
        return clear_bits(state, zeroed)

    def point(self, state: torch.Tensor, ys) -> torch.Tensor:
        return self.filter.point(state, ys)

    def range(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        return self.filter.range(state, lo, hi)

    def promoted(self, new_layout: FilterLayout,
                 state: torch.Tensor) -> tuple:
        """(new DeletableBloomRF, promoted state) under ``new_layout``."""
        out = DeletableBloomRF(new_layout, device=self.filter.device)
        out.counts = self.counts.promoted(self.layout, new_layout)
        return out, promote_state(state, self.layout, new_layout)
