"""Theoretical FPR / space model for bloomRF (paper §5–§7) plus the
comparison curves of Fig. 8 (Rosetta first-cut model and the Goswami et al.
range-emptiness lower bound, and the Carter et al. point lower bound).

Everything here is host-side float math (numpy), used by the tuning advisor,
the benchmarks, and the tests that validate our implementation against the
paper's own worked example (§7: n=3, d=16, Δ=4, m=32 -> p≈0.683,
point FPR ≈ 1%, top-level FPR ≈ 0.95).

A numpy-only copy of ``repro/core/model.py``: the port keeps its own so
that it never imports the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .layout import FilterLayout

__all__ = [
    "p_zero",
    "basic_point_fpr",
    "basic_range_fpr",
    "basic_space_for_fpr",
    "level_fprs",
    "range_fpr_max",
    "point_fpr",
    "rosetta_space_for_fpr",
    "point_lower_bound_space",
    "range_lower_bound_space",
]


# ---------------------------------------------------------------------------
# basic model (§5)
# ---------------------------------------------------------------------------

def p_zero(m_bits: float, n: int, k_inserts: float, C: float = 1.0) -> float:
    """Probability a given bit is still zero after inserting n keys that each
    set ``k_inserts`` bits in an ``m_bits`` segment.  C models distribution
    effects on PMHF scatter (C=1 for uniform/normal/zipfian, Fig. 5)."""
    if m_bits <= 0:
        return 0.0
    return float((1.0 - C / m_bits) ** (n * k_inserts))


def basic_point_fpr(d: int, n: int, m_bits: float, delta: int = 7,
                    C: float = 1.0) -> float:
    k = max(1, math.ceil((d - math.log2(max(n, 2))) / delta))
    p = p_zero(m_bits, n, k, C)
    return (1.0 - p) ** k


def basic_range_fpr(d: int, n: int, m_bits: float, R: float,
                    delta: int = 7, C: float = 1.0) -> float:
    """Eq. (6): eps <= 2 (1 - e^{-kn/m})^(k - log2(R)/delta)."""
    k = max(1, math.ceil((d - math.log2(max(n, 2))) / delta))
    p = p_zero(m_bits, n, k, C)
    expo = k - math.log2(max(R, 1.0)) / delta
    if expo <= 0:
        return 1.0
    return min(1.0, 2.0 * (1.0 - p) ** expo)


def basic_space_for_fpr(d: int, n: int, eps: float, R: float,
                        delta: int = 7) -> float:
    """Solve eq. (6) for m (bits) given a target range FPR ``eps``."""
    k = max(1, math.ceil((d - math.log2(max(n, 2))) / delta))
    expo = k - math.log2(max(R, 1.0)) / delta
    if expo <= 0:
        return float("inf")
    base = (eps / 2.0) ** (1.0 / expo)
    if base >= 1.0:
        return 0.0
    return k * n / (-math.log(1.0 - base))


# ---------------------------------------------------------------------------
# extended model (§7) — per-level FPR for arbitrary layouts
# ---------------------------------------------------------------------------

@dataclass
class LevelModel:
    fpr: np.ndarray    # (d+1,) per-level FPR
    tp: np.ndarray     # expected non-empty DIs per level
    fp: np.ndarray
    tn: np.ndarray
    p_seg: np.ndarray  # zero-bit probability per segment


def _expected_tp(d: int, n: int) -> np.ndarray:
    """Expected non-empty DIs per level, uniform keys.

    The paper's text suggests the shorthand ``min(n, 2^{d-l})`` but its worked
    example (§7: fpr_15 = 0.95 with n=3) uses the exact expectation
    ``slots * (1 - (1 - 1/slots)^n)``; we use the expectation.
    """
    lv = np.arange(d + 1, dtype=np.float64)
    slots = np.exp2(d - lv)
    out = np.empty_like(slots)
    multi = slots > 1
    with np.errstate(over="ignore"):
        out[multi] = slots[multi] * -np.expm1(
            n * np.log1p(-1.0 / slots[multi]))
    out[~multi] = 1.0  # a single slot is non-empty as soon as n >= 1
    return out


def level_fprs(layout: FilterLayout, n: int, C: float = 1.0) -> LevelModel:
    """Paper §7 'Extended Model': recursive per-level (fp, tn) estimation."""
    d = layout.d
    k = layout.k
    levels = layout.levels
    tp = _expected_tp(d, n)
    fp = np.zeros(d + 1)
    tn = np.zeros(d + 1)

    # per-segment zero-bit probability
    nseg = len(layout.seg_bits)
    p_seg = np.ones(nseg)
    for s in range(nseg):
        if layout.exact_seg is not None and s == layout.exact_seg:
            continue
        k_seg = sum(layout.replicas[i] for i in range(k)
                    if layout.seg_of_layer[i] == s)
        p_seg[s] = p_zero(layout.seg_alloc_bits[s], n, k_seg, C)

    top = layout.top_level
    # levels at/above the top covering level
    for lv in range(d, top - 1, -1):
        slots = float(2.0 ** (d - lv))
        if layout.has_exact and lv == top:
            fp[lv] = 0.0
            tn[lv] = max(slots - tp[lv], 0.0)
        elif lv == top and not layout.has_exact:
            # unstored top boundary: everything tests positive
            fp[lv] = max(slots - tp[lv], 0.0)
            tn[lv] = 0.0
        else:
            # saturated / omitted levels above the boundary
            fp[lv] = max(slots - tp[lv], 0.0)
            tn[lv] = 0.0

    for i in reversed(range(k)):
        li, li1 = levels[i], levels[i + 1]
        p = p_seg[layout.seg_of_layer[i]]
        r = layout.replicas[i]
        q_prefix = (1.0 - p) ** r  # P(single prefix passes its r probes)
        for lv in range(li1 - 1, li - 1, -1):
            span = 2.0 ** (li1 - lv)
            fp_pot = span * (fp[li1] + tp[li1]) - tp[lv]
            fp_pot = max(fp_pot, 0.0)
            run = 2.0 ** (lv - li)   # bits probed for a level-lv DI
            p_pos = 1.0 - (1.0 - q_prefix) ** run
            fp[lv] = p_pos * fp_pot
            tn[lv] = span * tn[li1] + (1.0 - p_pos) * fp_pot

    denom = fp + tn
    # 0/0 (every DI a true positive) reports FPR 0, matching the paper
    fpr = np.divide(fp, denom, out=np.zeros(d + 1), where=denom > 0)
    return LevelModel(fpr=fpr, tp=tp, fp=fp, tn=tn, p_seg=p_seg)


def range_fpr_max(layout: FilterLayout, n: int, R: float,
                  C: float = 1.0) -> float:
    """Advisor objective fpr_m: max FPR over DI levels used by ranges <= R."""
    lm = level_fprs(layout, n, C)
    top_lv = min(int(math.floor(math.log2(max(R, 1.0)))), layout.d)
    return float(np.max(lm.fpr[: top_lv + 1]))


def point_fpr(layout: FilterLayout, n: int, C: float = 1.0) -> float:
    return float(level_fprs(layout, n, C).fpr[0])


# ---------------------------------------------------------------------------
# comparison curves (Fig. 8)
# ---------------------------------------------------------------------------

def rosetta_space_for_fpr(n: int, eps: float, R: float) -> float:
    """Rosetta first-cut (F): m ≈ log2(e) * n * log2(R/eps)."""
    return math.log2(math.e) * n * math.log2(max(R, 2.0) / eps)


def point_lower_bound_space(n: int, eps: float) -> float:
    """Carter et al. [7]: m >= n log2(1/eps)."""
    return n * math.log2(1.0 / eps)


def range_lower_bound_space(n: int, eps: float, R: float, d: int = 64) -> float:
    """Goswami et al. [20] family over gamma > 1; pointwise max."""
    best = 0.0
    for g in np.geomspace(1.0 + 1e-6, 1e6, 4096):
        if g * eps >= 1.0:
            continue
        t1 = n * math.log2(R ** (1.0 - g * eps) / eps)
        inner = (1.0 - 4.0 * n * R / 2.0 ** d) * (1.0 - 1.0 / g) / math.e
        if inner <= 0:
            continue
        t2 = n * math.log2(inner)
        best = max(best, t1 + t2)
    return best
