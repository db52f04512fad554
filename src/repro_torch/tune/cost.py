"""Sample-driven cost model: score a layout against a fitted workload.

The static advisor (``core/tuning.py``) prices one worst-case R.  Here
the §7 per-level model is *integrated over the observed range-length
distribution* instead: a range of length ~``2^l`` is answered from dyadic
levels ``0..l``, and the paper prices its FPR as the max per-level FPR
over those levels (``core.model.range_fpr_max``), so

    fpr_range = sum_l  w[l] * max(fpr[0..l])

with ``w`` the workload's range-log2 weights.  Points are level 0; the
workload's point/range mix blends the two.  Probe *cost* (not just
accuracy) enters through the engine's own accounting —
``ProbeEngine.range_word_loads``, the number of 32-bit words a range
probe gathers — as a small multiplicative penalty, so two layouts with
equal predicted FPR tie-break toward the cheaper probe plane.

``cross_check`` compares the model's prediction for the *live* layout
against the live ``observed_fpr()`` sample and reports the calibration
ratio; the solver works on relative wins (calibration cancels), but the
report is how a human audits the model before trusting a retune.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.engine import _filter_for_layout
from ..core.layout import FilterLayout
from ..core.model import level_fprs
from .workload import N_RANGE_BUCKETS, WorkloadModel

__all__ = ["CostReport", "score_layout", "words_per_range_query",
           "cross_check", "WORD_COST"]

_HOST = torch.device("cpu")

#: relative probe-cost weight: an extra gathered word costs this fraction
#: of the objective — a tie-breaker, never a trade against real FPR
WORD_COST = 1e-4


def words_per_range_query(layout: FilterLayout) -> float:
    """u32 words one range probe gathers, per the engine's own accounting
    (``ProbeEngine.range_word_loads``) — not a re-derivation.  A host
    count: scoring a layout never touches the card."""
    return float(_filter_for_layout(layout, _HOST).engine.range_word_loads)


@dataclasses.dataclass(frozen=True)
class CostReport:
    """Scored candidate: predicted FPRs under the workload + probe cost."""

    fpr_point: float        # level-0 FPR
    fpr_range: float        # FPR integrated over the range-length sample
    fpr_mix: float          # point/range blend per the observed query mix
    words_per_query: float  # gathered u32 words per range probe
    objective: float        # fpr_mix * (1 + WORD_COST * words)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def score_layout(layout: FilterLayout, n_keys: int,
                 workload: WorkloadModel, C: float = None,
                 word_cost: float = WORD_COST) -> CostReport:
    """Predict ``layout``'s cost on ``workload`` holding ``n_keys`` keys.

    ``C`` defaults to the workload's cluster-derived scatter factor."""
    if n_keys < 1:
        raise ValueError(f"n_keys must be >= 1, got {n_keys}")
    if C is None:
        C = workload.c_factor
    lm = level_fprs(layout, n_keys, C)
    # max per-level FPR over levels 0..l: the paper's fpr_m at R = 2^l
    cum_max = np.maximum.accumulate(lm.fpr)
    w = workload.range_weights()
    lv = np.minimum(np.arange(N_RANGE_BUCKETS), layout.d)
    fpr_range = float((w * cum_max[lv]).sum())
    fpr_point = float(lm.fpr[0])
    pf = workload.point_frac()
    fpr_mix = pf * fpr_point + (1.0 - pf) * fpr_range
    words = words_per_range_query(layout)
    return CostReport(fpr_point=fpr_point, fpr_range=fpr_range,
                      fpr_mix=fpr_mix, words_per_query=words,
                      objective=fpr_mix * (1.0 + word_cost * words))


def cross_check(layout: FilterLayout, n_keys: int,
                workload: WorkloadModel) -> dict:
    """Model-vs-live audit for the layout currently deployed.

    ``calibration`` is observed/predicted range FPR, clipped to [0.25, 4]
    (a reservoir of ~512 candidates is noisy); ~1 means the §7 model
    tracks the deployment, far from 1 means the filters degraded (churn,
    promotion hops) beyond what a fresh-build model can see."""
    rep = score_layout(layout, n_keys, workload)
    out = {"predicted_range_fpr": rep.fpr_range,
           "predicted_point_fpr": rep.fpr_point,
           "observed_range_fpr": workload.observed.get("range_fpr"),
           "observed_point_fpr": workload.observed.get("point_fpr"),
           "calibration": None}
    obs = out["observed_range_fpr"]
    if obs is not None and rep.fpr_range > 0:
        out["calibration"] = float(np.clip(obs / rep.fpr_range, 0.25, 4.0))
    return out
