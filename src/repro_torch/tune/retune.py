"""AdaptiveTuner: the observe → fit → solve → retune loop (§16).

One tuner serves one store (or tenant handle).  It owns:

* an ``obs.fpr.FprSampler`` fed from the host scan path (bounds
  reservoir + range-log2 histogram — cheap numpy, never on the device
  dispatch);
* a per-capacity-class **decision cache**: ``advise_layout`` is consulted
  by compaction exactly where a rebuild is already being paid for
  (class-graduating merges), re-solves at most every
  ``Hysteresis.cooldown`` consultations, and hands flushes the *cached*
  decision so new runs land directly in the tuned layout (keeping
  same-class merges on the free OR path);
* a retune **event log** (``events``) surfaced through
  ``TypedStore.retune_report()``.

Serialization rides the workload model (``bloomrf-workload/v1``): the
tuner snapshots its fitted sample and reloads it on restore, so a
reopened store resumes tuning from the observed workload instead of
cold-starting through the hysteresis gate again.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core.layout import FilterLayout
from ..obs.fpr import FprSampler
from .cost import cross_check
from .solver import Hysteresis, RetuneDecision, solve
from .workload import WorkloadModel, fit_workload

__all__ = ["AdaptiveTuner"]


class AdaptiveTuner:
    """Closed-loop layout tuner for one store/handle."""

    def __init__(self, d: int, seed: int = 0x0B100F11,
                 hysteresis: Optional[Hysteresis] = None,
                 sampler: Optional[FprSampler] = None):
        if not 1 <= d <= 64:
            raise ValueError(f"d must be in 1..64, got {d}")
        self.d = d
        self.hysteresis = hysteresis or Hysteresis()
        self.sampler = sampler if sampler is not None \
            else FprSampler(d, seed=seed ^ 0x7E4E)
        self.points_seen = 0
        self.observed: dict = {}     # live FPR samples (cross-check input)
        self.events: list = []       # solver-accepted retunes, in order
        self.retunes = 0             # len(events), kept as a plain counter
        self._decisions: Dict[FilterLayout, RetuneDecision] = {}
        self._since_solve: Dict[FilterLayout, int] = {}

    # -- observation hooks (host path only; never syncs a device value) --

    def observe_scan(self, lo, hi) -> None:
        """Feed scan bounds into the workload sample (host numpy)."""
        self.sampler.observe_ranges(np.asarray(lo, np.uint64),
                                    np.asarray(hi, np.uint64))

    def observe_points(self, n: int) -> None:
        self.points_seen += int(n)

    def record_observed(self, sample: dict) -> None:
        """Fold a live ``observed_fpr()`` sample into the cross-check."""
        for k in ("point_fpr", "range_fpr"):
            if sample.get(k) is not None:
                self.observed[k] = float(sample[k])

    # -- model ------------------------------------------------------------

    def workload(self, stats=None, keys=None) -> WorkloadModel:
        return fit_workload(self.d, sampler=self.sampler, stats=stats,
                            keys=keys, observed=self.observed,
                            n_points=self.points_seen)

    def cross_check(self, layout: FilterLayout, n_keys: int) -> dict:
        return cross_check(layout, max(n_keys, 1), self.workload())

    # -- the retune point --------------------------------------------------

    def cached_layout(self, ladder_layout: FilterLayout
                      ) -> Optional[FilterLayout]:
        """The standing decision for a capacity class, without solving.

        The flush path uses this so fresh runs join the class's tuned
        layout (same-class compactions then merge with a free OR)."""
        dec = self._decisions.get(ladder_layout)
        return dec.layout if dec is not None and dec.changed else None

    def advise_layout(self, ladder_layout: FilterLayout,
                      n_keys: int) -> FilterLayout:
        """The layout a (re)build at this capacity class should use.

        Called by compaction when the rebuild is already being paid for.
        Re-solves at most every ``cooldown`` consultations per class;
        between solves the cached decision holds."""
        h = self.hysteresis
        if self.sampler.workload_seen < h.min_ranges:
            return ladder_layout
        n_since = self._since_solve.get(ladder_layout)
        if (n_since is not None and n_since < h.cooldown
                and ladder_layout in self._decisions):
            self._since_solve[ladder_layout] = n_since + 1
            return self._decisions[ladder_layout].layout
        prev = self._decisions.get(ladder_layout)
        dec = solve(self.workload(), max(n_keys, 1), ladder_layout, h)
        self._decisions[ladder_layout] = dec
        self._since_solve[ladder_layout] = 0
        if dec.changed and (prev is None or prev.layout != dec.layout):
            self.retunes += 1
            self.events.append({
                "class_deltas": list(ladder_layout.deltas),
                "tuned_deltas": list(dec.layout.deltas),
                "tuned_replicas": list(dec.layout.replicas),
                "n_keys": int(n_keys),
                "win": float(dec.win),
                "predicted_fpr_mix": float(dec.best.fpr_mix),
                "baseline_fpr_mix": float(dec.baseline.fpr_mix),
                "reason": dec.reason,
            })
        return dec.layout

    def report(self) -> dict:
        """Human-auditable state: decisions, events, fitted workload."""
        wl = self.workload()
        return {
            "retunes": self.retunes,
            "events": list(self.events),
            "workload": wl.to_dict(),
            "decisions": {
                str(lad.deltas): {
                    "tuned_deltas": list(dec.layout.deltas),
                    "changed": dec.changed,
                    "win": float(dec.win),
                    "reason": dec.reason,
                } for lad, dec in self._decisions.items()},
        }

    # -- serde (rides in Store.snapshot as "workload") --------------------

    def to_dict(self) -> dict:
        return self.workload().to_dict()

    def load(self, enc: dict) -> None:
        """Resume from a serialized workload model (snapshot restore);
        malformed input raises ``ValueError``."""
        model = WorkloadModel.from_dict(enc)
        if model.d != self.d:
            raise ValueError(f"workload model is for d={model.d}, "
                             f"tuner is d={self.d}")
        self.sampler.preload_workload(model.reservoir, model.n_ranges,
                                      model.range_log2)
        self.points_seen = model.n_points
        self.observed.update(model.observed)
