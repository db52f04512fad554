"""Static layout of a bloomRF filter.

Counterpart of ``repro/core/layout.py``, copied without its JAX check.
Everything here is host-side python/numpy computed once at construction
time; the torch code and the CUDA kernels read these quantities as
constants (the kernels through a per-layout descriptor table).

Terminology follows the paper (Table 1):

* ``d``            — domain bits (UINT8..UINT64 domains).
* layer ``i``      — index of a (PMHF) hash function, bottom-first ``0..k-1``.
* ``deltas[i]``    — distance :math:`\\Delta_i` between level ``l_i`` and
                     ``l_{i+1}``; bottom-first (paper writes the vector
                     top-first: ``(2,2,4,7,7,7,7)`` == deltas ``(7,7,7,7,4,2,2)``).
* ``levels[i]``    — dyadic level handled by layer ``i``; ``levels[k]`` is the
                     *top covering level* (either ``d``, the saturation cut, or
                     the exact-bitmap level).
* word ``W_i``     — :math:`2^{\\Delta_i-1}` bits; the unit PMHF read/write.
                     Represented as 1–2 uint32 lanes (W in {1,2,4,8,16,32,64}).
* replicas ``r_i`` — replicated hash functions per layer (error correction).
* segments        — the bit-array is split into segments ``m_1..m_S``; each
                     hashed layer is assigned one segment; at most one segment
                     is an *exact* (identity-mapped) bitmap of level
                     ``levels[k]``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import cached_property
from typing import Optional

import numpy as np

from .hashing import derive_seeds

__all__ = ["FilterLayout", "basic_layout"]

_LANE = 32  # storage lane width (uint32)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class FilterLayout:
    """Frozen bloomRF configuration + derived addressing tables."""

    d: int                                 # domain bits
    deltas: tuple                          # bottom-first Δ_i, len k
    replicas: tuple                        # r_i per layer, len k
    seg_of_layer: tuple                    # segment index per hashed layer
    seg_bits: tuple                        # requested bits per segment
    exact_seg: Optional[int] = None        # which segment is the exact bitmap
    seed: int = 0x0B100F11  # "bloomRF"
    max_exact_scan_lanes: int = 1 << 14    # range-scan cap on the exact bitmap

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def __post_init__(self):
        k = len(self.deltas)
        if k == 0:
            raise ValueError("need at least one layer")
        if len(self.replicas) != k or len(self.seg_of_layer) != k:
            raise ValueError("deltas/replicas/seg_of_layer length mismatch")
        for dl in self.deltas:
            if not (1 <= dl <= 7):
                raise ValueError(f"delta must be in 1..7 (word <= 64 bits), got {dl}")
        for r in self.replicas:
            if r < 1:
                raise ValueError("replicas must be >= 1")
        if sum(self.deltas) > self.d:
            raise ValueError(
                f"levels overflow domain: sum(deltas)={sum(self.deltas)} > d={self.d}"
            )
        nseg = len(self.seg_bits)
        for s in self.seg_of_layer:
            if not (0 <= s < nseg):
                raise ValueError("seg_of_layer out of range")
            if self.exact_seg is not None and s == self.exact_seg:
                raise ValueError("hashed layers cannot live in the exact segment")
        if self.exact_seg is not None:
            if not (0 <= self.exact_seg < nseg):
                raise ValueError("exact_seg out of range")
            need = 1 << (self.d - self.top_level)
            if self.seg_bits[self.exact_seg] < need:
                raise ValueError(
                    f"exact segment needs 2^(d-l_e) = {need} bits, "
                    f"got {self.seg_bits[self.exact_seg]}"
                )
        # every hashed segment must fit at least 2 words of each resident layer
        for i in range(k):
            if self.nwords(i) < 2:
                raise ValueError(f"segment of layer {i} too small for its word size")

    @classmethod
    def from_dict(cls, d: dict) -> "FilterLayout":
        """Rebuild a layout from its ``dataclasses.asdict`` form (the form a
        run snapshot stores); JSON lists become the tuples the fields hold."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown FilterLayout fields: {sorted(unknown)}")
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}
        return cls(**kw)

    # ------------------------------------------------------------------
    # derived quantities (all python ints / numpy — trace-time constants)
    # ------------------------------------------------------------------
    @property
    def k(self) -> int:
        return len(self.deltas)

    @cached_property
    def levels(self) -> tuple:
        """levels[i] for i in 0..k; levels[k] is the top covering level."""
        lv = [0]
        for dl in self.deltas:
            lv.append(lv[-1] + dl)
        return tuple(lv)

    @property
    def top_level(self) -> int:
        return self.levels[self.k]

    @property
    def has_exact(self) -> bool:
        return self.exact_seg is not None

    @property
    def exact_level(self) -> Optional[int]:
        return self.top_level if self.has_exact else None

    def word_bits(self, i: int) -> int:
        return 1 << (self.deltas[i] - 1)

    @cached_property
    def _seg_alloc(self) -> tuple:
        """(aligned_bits, offset_bits) per segment.

        A segment hosting 64-bit words must start and size-align to 64 bits
        (so W=64 words begin on even lanes); everything else aligns to 32.
        """
        aligns = []
        for s in range(len(self.seg_bits)):
            a = 32
            for i in range(len(self.deltas)):
                if self.seg_of_layer[i] == s and self.word_bits(i) == 64:
                    a = 64
            aligns.append(a)
        offs, sizes = [], []
        cur = 0
        for s, bits in enumerate(self.seg_bits):
            if self.exact_seg is not None and s == self.exact_seg:
                bits = 1 << (self.d - self.top_level)  # exact size, no rounding
            aligned = _round_up(max(bits, aligns[s]), aligns[s])
            cur = _round_up(cur, aligns[s])
            offs.append(cur)
            sizes.append(aligned)
            cur += aligned
        return tuple(sizes), tuple(offs)

    @property
    def seg_alloc_bits(self) -> tuple:
        return self._seg_alloc[0]

    @property
    def seg_off_bits(self) -> tuple:
        return self._seg_alloc[1]

    @property
    def total_bits(self) -> int:
        sizes, offs = self._seg_alloc
        return _round_up(offs[-1] + sizes[-1], 32)

    @property
    def total_u32(self) -> int:
        return self.total_bits // _LANE

    def nwords(self, i: int) -> int:
        """Number of PMHF words of layer i in its segment."""
        s = self.seg_of_layer[i]
        return self.seg_alloc_bits[s] // self.word_bits(i)

    @property
    def exact_off_bits(self) -> int:
        assert self.exact_seg is not None
        return self.seg_off_bits[self.exact_seg]

    @property
    def exact_nbits(self) -> int:
        assert self.exact_seg is not None
        return 1 << (self.d - self.top_level)

    @cached_property
    def seeds(self) -> np.ndarray:
        """uint64 seeds, shape (k, max_replicas)."""
        rmax = max(self.replicas)
        flat = derive_seeds(self.seed, self.k * rmax)
        return flat.reshape(self.k, rmax)

    @property
    def bits_per_key(self) -> float:
        """Bits set per inserted key (hashed replicas + exact bit)."""
        return sum(self.replicas) + (1 if self.has_exact else 0)

    def describe(self) -> str:
        rows = [
            f"bloomRF layout: d={self.d} k={self.k} total_bits={self.total_bits}"
            f" (~{self.total_bits/1024:.1f} Kbit) exact_level="
            f"{self.exact_level} top_level={self.top_level}"
        ]
        for i in reversed(range(self.k)):
            rows.append(
                f"  layer {i}: levels [{self.levels[i]},{self.levels[i+1]}) "
                f"delta={self.deltas[i]} word={self.word_bits(i)}b "
                f"r={self.replicas[i]} seg={self.seg_of_layer[i]} "
                f"nwords={self.nwords(i)}"
            )
        for s, (bits, off) in enumerate(zip(self.seg_alloc_bits, self.seg_off_bits)):
            kind = "exact" if s == self.exact_seg else "hashed"
            rows.append(f"  segment {s}: {bits} bits @ {off} ({kind})")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def basic_layout(
    d: int,
    n_keys: int,
    bits_per_key: float = 16.0,
    delta: int = 7,
    seed: int = 0x0B100F11,
) -> FilterLayout:
    """Basic (tuning-free) bloomRF of the paper (§3–§5).

    Equidistant levels ``l_i = i*delta``; ``k = ceil((d - log2 n)/delta)``
    hash functions (saturated top levels omitted); a single shared segment of
    ``n * bits_per_key`` bits; one hash function per layer; no exact layer.
    """
    if n_keys < 1:
        raise ValueError("n_keys must be >= 1")
    log2n = math.log2(max(n_keys, 2))
    k = max(1, math.ceil((d - log2n) / delta))
    k = min(k, max(1, math.ceil(d / delta)))
    # clamp levels into the domain: shrink top distances if sum overflows d
    deltas = [delta] * k
    while sum(deltas) > d:
        if deltas[-1] > 1:
            deltas[-1] -= 1
        else:
            deltas.pop()
    k = len(deltas)
    # every resident layer needs >= 2 words in its segment
    min_bits = 2 * (1 << (max(deltas) - 1))
    m = _round_up(max(int(n_keys * bits_per_key), min_bits, 64), 64)
    return FilterLayout(
        d=d,
        deltas=tuple(deltas),
        replicas=(1,) * k,
        seg_of_layer=(0,) * k,
        seg_bits=(m,),
        exact_seg=None,
        seed=seed,
    )
