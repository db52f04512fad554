"""Tuning advisor (paper §7).

Given standard parameters — number of keys ``n``, memory budget ``m`` (bits),
an (approximate max) query-range size ``R`` and the domain width ``d`` — the
advisor computes a full bloomRF configuration: the distance vector Δ, replica
counts r_i, segment assignment j_i and the three segment sizes (m1, m2, m3),
minimizing the weighted norm ``fpr_w^2 = fpr_m^2 + C^2 * fpr_p^2``.

Heuristics follow the paper:
* exact level candidates: smallest l with 2^(d-l) < 0.6 m, and that +1;
* bottom layers use Δ=7 (64-bit words), distances shrink towards the exact
  level (e.g. target 36 -> Δ = (7,7,7,7,4,2,2) bottom-first);
* one replica everywhere except the topmost hashed layer (2);
* m1 = exact bitmap, m2 = mid layers (Δ<7), m3 = bottom layers; m2 is swept.

A numpy-only copy of ``repro/core/tuning.py``: the port keeps its own so
that it never imports the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .layout import FilterLayout
from .model import level_fprs

__all__ = ["advise", "AdvisorResult"]


def _delta_vector(target: int) -> list:
    """Bottom-first Δ vector summing to ``target``; big words at the bottom,
    halving distances towards the top (paper's example: 36 -> 7,7,7,7,4,2,2)."""
    deltas = []
    rem = target
    while rem >= 14:
        deltas.append(7)
        rem -= 7
    if rem == 7:
        deltas.append(7)
        rem = 0
    while rem > 0:
        step = rem if rem <= 2 else min(7, max(2, rem // 2))
        deltas.append(step)
        rem -= step
    if not deltas:
        deltas = [1]
    return deltas


@dataclass
class AdvisorResult:
    layout: FilterLayout
    fpr_point: float
    fpr_range_max: float
    fpr_w: float
    exact_level: int


def _build_candidate(d: int, n: int, m_bits: int, exact_level: int,
                     m2_frac: float, seed: int) -> Optional[FilterLayout]:
    m1 = 1 << (d - exact_level)
    if m1 >= m_bits:
        return None
    rest = m_bits - m1
    deltas = _delta_vector(exact_level)
    k = len(deltas)
    # segment assignment: bottom (Δ==7) -> seg 2 (m3); mid -> seg 1 (m2)
    seg_of_layer = tuple(2 if dl == 7 else 1 for dl in deltas)
    if all(s == 2 for s in seg_of_layer):
        seg_of_layer = tuple([2] * (k - 1) + [1])  # topmost layer -> mid seg
    replicas = [1] * k
    replicas[-1] = 2  # topmost hashed layer gets error-correction replica
    m2 = int(rest * m2_frac)
    m3 = rest - m2
    if m2 < 256 or m3 < 256:
        return None
    try:
        return FilterLayout(
            d=d,
            deltas=tuple(deltas),
            replicas=tuple(replicas),
            seg_of_layer=seg_of_layer,
            seg_bits=(m1, m2, m3),
            exact_seg=0,
            seed=seed,
        )
    except ValueError:
        return None


def advise(d: int, n: int, m_bits: int, R: float,
           point_weight: float = 1.0, C: float = 1.0,
           seed: int = 0x0B100F11) -> AdvisorResult:
    """Select a bloomRF configuration for ranges up to ``R`` within ``m_bits``.

    Raises ``ValueError`` for out-of-range inputs (d outside 1..64,
    non-positive n or m_bits, R < 1) and when no feasible configuration
    exists within the memory budget — never a silent bad layout or a
    deep assertion failure."""
    if not 1 <= d <= 64:
        raise ValueError(f"d must be in 1..64 (uint64 key domain), got {d}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if m_bits < 1:
        raise ValueError(f"m_bits must be >= 1, got {m_bits}")
    if not R >= 1:
        raise ValueError(f"R must be >= 1, got {R}")
    # exact level heuristic: smallest level whose bitmap is < 60% of budget
    l_e = next((lv for lv in range(d + 1) if 2.0 ** (d - lv) < 0.6 * m_bits),
               None)
    if l_e is None:
        raise ValueError(
            f"advisor found no feasible exact level for d={d} within "
            f"m_bits={m_bits}; increase the memory budget")
    l_e = max(1, l_e)
    top_range_lv = min(int(math.ceil(math.log2(max(R, 2.0)))), d)

    best: Optional[AdvisorResult] = None
    for cand in {l_e, min(l_e + 1, d)}:
        for frac in np.linspace(0.15, 0.75, 9):
            lay = _build_candidate(d, n, m_bits, cand, float(frac), seed)
            if lay is None:
                continue
            lm = level_fprs(lay, n, C)
            fpr_p = float(lm.fpr[0])
            fpr_m = float(np.max(lm.fpr[: top_range_lv + 1]))
            fpr_w = math.hypot(fpr_m, point_weight * fpr_p)
            if best is None or fpr_w < best.fpr_w:
                best = AdvisorResult(lay, fpr_p, fpr_m, fpr_w, cand)
    if best is None:
        raise ValueError(
            f"advisor found no feasible configuration for d={d} n={n} "
            f"m={m_bits} R={R}; increase the memory budget"
        )
    return best
