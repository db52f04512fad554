"""Layout re-solver: search the candidate space under the workload
objective, with hysteresis so retuning never thrashes.

The candidate space is the one ``core/tuning.py::advise`` sweeps —
Δ-vector shapes (uniform ladders δ=1..7, the paper's shrink-towards-the-
top vectors) and replica splits — restricted to **hashed single-segment
layouts at the current layout's bit budget**.  Two deliberate bounds:

* *equal bits per key*: every candidate gets the incumbent's ``m`` so a
  "win" is a better Δ geometry, never just more memory;
* *no exact-bitmap segments*: the store's probe planes (the stacked
  one-gather plan and the scan megakernel) only stack hashed layouts —
  an exact-level candidate would win the cost model and then be
  unprobeable (the same reason ``FilterSpec`` pins ``tuning='advised'``
  to the single placement).

Hysteresis (Memento's robustness argument, PAPERS.md): a retune must
beat the incumbent by ``min_win`` *predicted* relative objective, the
solver re-runs at most every ``cooldown`` consultations per capacity
class, and nothing is solved before ``min_ranges`` observed queries —
three knobs that together keep a borderline workload from flip-flopping
layouts at every compaction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from ..core.layout import FilterLayout, _round_up
from ..core.tuning import _delta_vector
from .cost import CostReport, score_layout
from .workload import WorkloadModel

__all__ = ["Hysteresis", "RetuneDecision", "candidate_layouts", "solve"]


@dataclasses.dataclass(frozen=True)
class Hysteresis:
    """Anti-thrash policy: when is a predicted win worth acting on?"""

    min_win: float = 0.10    # required relative objective improvement
    cooldown: int = 2        # consultations between re-solves (per class)
    min_ranges: int = 64     # observed ranges before solving at all

    def __post_init__(self):
        if not 0.0 <= self.min_win < 1.0:
            raise ValueError(f"min_win must be in [0, 1), "
                             f"got {self.min_win}")
        if self.cooldown < 0 or self.min_ranges < 0:
            raise ValueError("cooldown and min_ranges must be >= 0")


@dataclasses.dataclass(frozen=True)
class RetuneDecision:
    """One solver verdict for one capacity class."""

    layout: FilterLayout     # what to build (the incumbent when not won)
    changed: bool            # did a candidate clear the hysteresis bar?
    win: float               # best relative objective improvement found
    baseline: CostReport     # incumbent under the workload
    best: CostReport         # winning (or incumbent) report
    n_candidates: int
    reason: str


def _ladder_deltas(d: int, n_keys: int, delta: int) -> Tuple[int, ...]:
    """The uniform-δ ladder ``basic_layout`` would pick, clamped into d."""
    log2n = math.log2(max(n_keys, 2))
    k = max(1, math.ceil((d - log2n) / delta))
    k = min(k, max(1, math.ceil(d / delta)))
    deltas = [delta] * k
    while sum(deltas) > d:
        if deltas[-1] > 1:
            deltas[-1] -= 1
        else:
            deltas.pop()
    return tuple(deltas)


def _hashed(d: int, m_bits: int, deltas: Tuple[int, ...],
            replicas: Optional[Tuple[int, ...]] = None,
            seed: int = 0x0B100F11) -> Optional[FilterLayout]:
    """Hashed single-segment candidate at (>=) the given bit budget, or
    None when the geometry is infeasible."""
    if not deltas:
        return None
    k = len(deltas)
    min_bits = 2 * (1 << (max(deltas) - 1))  # >= 2 words per layer
    m = _round_up(max(int(m_bits), min_bits, 64), 64)
    try:
        return FilterLayout(d=d, deltas=tuple(deltas),
                            replicas=replicas or (1,) * k,
                            seg_of_layer=(0,) * k, seg_bits=(m,),
                            exact_seg=None, seed=seed)
    except ValueError:
        return None


def candidate_layouts(current: FilterLayout, n_keys: int,
                      seed: Optional[int] = None) -> List[FilterLayout]:
    """The search space around ``current`` at its own bit budget."""
    d = current.d
    m = current.seg_bits[0] if len(current.seg_bits) == 1 \
        else current.total_bits
    seed = current.seed if seed is None else seed
    shapes: dict = {}
    for delta in range(1, min(7, d) + 1):
        deltas = _ladder_deltas(d, n_keys, delta)
        shapes.setdefault((deltas, None), None)
        if delta <= 3 and len(deltas) > 1:
            # error-correction replica on the top hashed layer (§7)
            reps = (1,) * (len(deltas) - 1) + (2,)
            shapes.setdefault((deltas, reps), None)
    # paper-style shrink vectors: big words at the bottom, halving upward
    log2n = int(math.log2(max(n_keys, 2)))
    for target in {d, max(d - log2n, 1)}:
        shapes.setdefault((tuple(_delta_vector(target)), None), None)
    out = []
    for (deltas, reps) in shapes:
        lay = _hashed(d, m, deltas, reps, seed)
        if lay is not None and lay != current:
            out.append(lay)
    return out


def solve(workload: WorkloadModel, n_keys: int, current: FilterLayout,
          hysteresis: Hysteresis = Hysteresis(),
          seed: Optional[int] = None) -> RetuneDecision:
    """Re-solve the layout for ``workload``; hysteresis-gated.

    Returns the incumbent (``changed=False``) when too little workload
    has been observed or no candidate clears ``min_win`` — the caller
    can always act on ``decision.layout`` unconditionally."""
    baseline = score_layout(current, n_keys, workload)
    if workload.n_ranges < hysteresis.min_ranges:
        return RetuneDecision(
            layout=current, changed=False, win=0.0, baseline=baseline,
            best=baseline, n_candidates=0,
            reason=f"insufficient workload ({workload.n_ranges} ranges "
                   f"< {hysteresis.min_ranges})")
    cands = candidate_layouts(current, n_keys, seed)
    best_lay, best = current, baseline
    for lay in cands:
        rep = score_layout(lay, n_keys, workload)
        if rep.objective < best.objective:
            best_lay, best = lay, rep
    win = 1.0 - best.objective / max(baseline.objective, 1e-300)
    if best_lay is current or win < hysteresis.min_win:
        return RetuneDecision(
            layout=current, changed=False, win=max(win, 0.0),
            baseline=baseline, best=baseline, n_candidates=len(cands),
            reason=f"no candidate beat min_win={hysteresis.min_win} "
                   f"(best win {max(win, 0.0):.3f})")
    return RetuneDecision(
        layout=best_lay, changed=True, win=win, baseline=baseline,
        best=best, n_candidates=len(cands),
        reason=f"deltas {current.deltas} -> {best_lay.deltas}, predicted "
               f"mixed FPR {baseline.fpr_mix:.4f} -> {best.fpr_mix:.4f}")
