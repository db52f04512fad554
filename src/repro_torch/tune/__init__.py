"""Workload-adaptive tuning: observe → cost-model → re-solve → retune.

A copy of ``repro.tune`` (numpy only) over the port's ``core`` and
``obs.fpr``; every score, decision and event equals the reference's.

The closed loop over the §6/§7 model (DESIGN.md §16):

* :mod:`~repro_torch.tune.workload` — :class:`WorkloadModel` fitted from the
  obs plane's samples, serializable as ``bloomrf-workload/v1``;
* :mod:`~repro_torch.tune.cost` — scores any ``FilterLayout`` against the
  fitted workload (FPR integrated over the range-length sample + the
  engine's probed-words accounting);
* :mod:`~repro_torch.tune.solver` — re-solves the layout over the advisor's
  candidate space under the workload objective, hysteresis-gated;
* :mod:`~repro_torch.tune.retune` — :class:`AdaptiveTuner`, the wiring the
  store's compaction path and the facade consult.

Opt in with ``FilterSpec(tuning="adaptive")`` (store/tenant placements)
or ``StoreConfig(tuning="adaptive")``.
"""
from .cost import CostReport, cross_check, score_layout
from .retune import AdaptiveTuner
from .solver import Hysteresis, RetuneDecision, candidate_layouts, solve
from .workload import SCHEMA, WorkloadModel, fit_workload

__all__ = [
    "AdaptiveTuner", "CostReport", "Hysteresis", "RetuneDecision",
    "SCHEMA", "WorkloadModel", "candidate_layouts", "cross_check",
    "fit_workload", "score_layout", "solve",
]
