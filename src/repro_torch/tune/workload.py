"""Workload model: what the deployment actually asks the filter (§16).

The §6/§7 advisor designs for a *worst case* — one range budget R, a
uniform key space, a guessed point/range mix.  A :class:`WorkloadModel`
replaces those guesses with the live sample the obs plane already
collects (Proteus' central observation, PAPERS.md):

* the **range-length distribution** — the ``obs/fpr.FprSampler`` bounds
  reservoir plus its host ``range_log2`` histogram, bucketed by
  ``ceil(log2 len)`` so each bucket maps 1:1 onto the dyadic level the
  paper's per-level model prices;
* the **point/range query mix** — point probes stress only level 0, so a
  point-heavy workload wants different Δs than a scan-heavy one;
* **key-cluster density** over the ``2^d`` code domain — a mild PMHF
  scatter adjustment (the paper's C, Fig. 5) for heavily clustered key
  spaces;
* the **observed FPR** of the live layout — the cost model's predictions
  are cross-checked against what the deployment actually leaks
  (``cost.cross_check``).

The model serializes as ``bloomrf-workload/v1`` (reservoir included) so
it rides inside ``Store.snapshot()`` and the tuner resumes with its
sample after a reopen instead of restarting cold.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

SCHEMA = "bloomrf-workload/v1"

#: range-length buckets: index = ceil(log2 length), 0..64 (length 1 -> 0)
N_RANGE_BUCKETS = 65
#: key-density resolution: top log2(64)=6 bits of the code domain
N_DENSITY_BUCKETS = 64

__all__ = ["SCHEMA", "WorkloadModel", "fit_workload", "range_log2_bucket"]


def range_log2_bucket(lengths) -> np.ndarray:
    """Bucket index per range length: ``ceil(log2 len)`` clipped to 0..64."""
    lengths = np.maximum(np.asarray(lengths, np.float64), 1.0)
    return np.clip(np.ceil(np.log2(lengths)), 0,
                   N_RANGE_BUCKETS - 1).astype(np.int64)


@dataclasses.dataclass
class WorkloadModel:
    """Fitted workload sample; the cost model's only input besides n."""

    d: int                       # code-domain bits of the *observed* queries
    range_log2: np.ndarray       # (65,) counts per ceil(log2 len) bucket
    n_ranges: int                # total range queries observed
    n_points: int                # total point queries observed
    key_density: np.ndarray      # (64,) key-mass fraction per domain slice
    observed: dict               # live cross-check inputs (e.g. range_fpr)
    reservoir: Tuple[Tuple[int, int], ...]  # raw sampled (lo, hi) bounds

    # -- derived views ----------------------------------------------------

    def point_frac(self) -> float:
        """Fraction of queries that are point probes."""
        total = self.n_points + self.n_ranges
        return self.n_points / total if total else 0.0

    def range_weights(self, default_log2: int = 8) -> np.ndarray:
        """(65,) probability weights over range-length buckets.

        With no ranges observed yet the weight collapses onto
        ``default_log2`` (a spec-style R budget) so the cost model
        degrades to the static advisor's single-R objective."""
        w = np.asarray(self.range_log2, np.float64)
        total = float(w.sum())
        if total <= 0:
            w = np.zeros(N_RANGE_BUCKETS)
            w[min(max(default_log2, 0), N_RANGE_BUCKETS - 1)] = 1.0
            return w
        return w / total

    @property
    def c_factor(self) -> float:
        """PMHF scatter adjustment from key clustering (paper's C).

        Fig. 5 shows C ~= 1 for uniform/normal/zipfian keys, so this
        stays a *mild* correction: the normalized Herfindahl index of
        the key-density histogram (1 for uniform mass), fourth-rooted
        and capped at 1.5."""
        dens = np.asarray(self.key_density, np.float64)
        if dens.sum() <= 0:
            return 1.0
        dens = dens / dens.sum()
        hhi = float((dens ** 2).sum()) * N_DENSITY_BUCKETS
        return float(min(1.5, max(1.0, hhi ** 0.25)))

    def rescaled(self, shift_log2: int) -> "WorkloadModel":
        """The same workload with every range length scaled by
        ``2^shift_log2`` — e.g. ``shift_log2 = -log2(n_shards)`` prices a
        full-domain scan against a *shard-local* layout, where the scan's
        per-shard slice is ~``len / n_shards``."""
        if shift_log2 == 0:
            return self
        counts = np.zeros(N_RANGE_BUCKETS)
        idx = np.clip(np.arange(N_RANGE_BUCKETS) + shift_log2, 0,
                      N_RANGE_BUCKETS - 1)
        np.add.at(counts, idx, np.asarray(self.range_log2, np.float64))
        return dataclasses.replace(self, range_log2=counts)

    # -- serde (rides in Store.snapshot) ----------------------------------

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "d": int(self.d),
            "range_log2": [float(c) for c in self.range_log2],
            "n_ranges": int(self.n_ranges),
            "n_points": int(self.n_points),
            "key_density": [float(c) for c in self.key_density],
            "observed": {str(k): float(v)
                         for k, v in self.observed.items()},
            "reservoir": [[int(a), int(b)] for a, b in self.reservoir],
        }

    @classmethod
    def from_dict(cls, enc: dict) -> "WorkloadModel":
        """Validated inverse of :meth:`to_dict`; malformed input raises an
        actionable ``ValueError`` (snapshot-restore contract)."""
        if not isinstance(enc, dict):
            raise ValueError(
                f"workload model must be a dict, got {type(enc).__name__}")
        if enc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a workload model: schema {enc.get('schema')!r} "
                f"(expected {SCHEMA!r})")
        d = enc.get("d")
        if not isinstance(d, int) or not 1 <= d <= 64:
            raise ValueError(f"workload model: d must be an int in 1..64, "
                             f"got {d!r}")

        def _vec(name, size):
            v = enc.get(name)
            if (not isinstance(v, (list, tuple)) or len(v) != size
                    or not all(isinstance(x, (int, float))
                               and not isinstance(x, bool)
                               and x >= 0 for x in v)):
                raise ValueError(f"workload model: {name!r} must be "
                                 f"{size} non-negative numbers")
            return np.asarray(v, np.float64)

        range_log2 = _vec("range_log2", N_RANGE_BUCKETS)
        key_density = _vec("key_density", N_DENSITY_BUCKETS)
        counts = {}
        for name in ("n_ranges", "n_points"):
            v = enc.get(name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ValueError(f"workload model: {name!r} must be a "
                                 f"non-negative int, got {v!r}")
            counts[name] = v
        obs = enc.get("observed", {})
        if (not isinstance(obs, dict)
                or not all(isinstance(k, str)
                           and isinstance(v, (int, float))
                           and not isinstance(v, bool)
                           for k, v in obs.items())):
            raise ValueError("workload model: 'observed' must map names "
                             "to numbers")
        res = enc.get("reservoir", [])
        top = (1 << d) - 1 if d < 64 else 2 ** 64 - 1
        if (not isinstance(res, (list, tuple))
                or not all(isinstance(p, (list, tuple)) and len(p) == 2
                           and all(isinstance(x, int)
                                   and not isinstance(x, bool)
                                   and 0 <= x <= top for x in p)
                           and p[0] <= p[1] for p in res)):
            raise ValueError(
                "workload model: 'reservoir' must be [lo, hi] pairs with "
                f"0 <= lo <= hi < 2^{d}")
        return cls(d=d, range_log2=range_log2,
                   n_ranges=counts["n_ranges"], n_points=counts["n_points"],
                   key_density=key_density,
                   observed={str(k): float(v) for k, v in obs.items()},
                   reservoir=tuple((int(a), int(b)) for a, b in res))


def fit_workload(d: int, *, sampler=None, stats=None,
                 keys: Optional[Sequence] = None,
                 observed: Optional[dict] = None,
                 n_points: int = 0) -> WorkloadModel:
    """Fit a :class:`WorkloadModel` from the live observation hooks.

    ``sampler`` is an ``obs.fpr.FprSampler`` (range histogram + bounds
    reservoir); ``stats`` a ``store.StoreStats`` (point/range mix and FP
    read rates); ``keys`` a sample of live keys (cluster density); every
    input is optional — missing pieces fall back to neutral defaults so a
    cold tuner still produces a scoreable (if uninformative) model.
    """
    if not 1 <= d <= 64:
        raise ValueError(f"d must be in 1..64, got {d}")
    range_log2 = np.zeros(N_RANGE_BUCKETS)
    n_ranges = 0
    reservoir: Tuple[Tuple[int, int], ...] = ()
    if sampler is not None:
        range_log2 = np.asarray(sampler.range_log2_counts,
                                np.float64).copy()
        n_ranges = int(sampler.workload_seen)
        reservoir = tuple((int(a), int(b))
                          for a, b in sampler.workload_sample())
    obs = dict(observed or {})
    if stats is not None:
        n_points = int(getattr(stats, "gets", n_points))
        if getattr(stats, "scans", 0) and not n_ranges:
            n_ranges = int(stats.scans)
        if getattr(stats, "scan_runs_touched", 0):
            obs.setdefault("scan_fp_read_rate",
                           float(stats.scan_fp_read_rate))
    key_density = np.full(N_DENSITY_BUCKETS, 1.0 / N_DENSITY_BUCKETS)
    if keys is not None:
        ks = np.asarray(keys, np.uint64)
        if ks.size:
            shift = np.uint64(max(d - int(math.log2(N_DENSITY_BUCKETS)), 0))
            idx = np.minimum(ks >> shift, N_DENSITY_BUCKETS - 1)
            key_density = (np.bincount(idx.astype(np.int64),
                                       minlength=N_DENSITY_BUCKETS)
                           / ks.size)
    return WorkloadModel(d=d, range_log2=range_log2, n_ranges=n_ranges,
                         n_points=int(n_points), key_density=key_density,
                         observed=obs, reservoir=reservoir)
