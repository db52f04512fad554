"""Live FPR telemetry: known-absent reservoirs re-probed on demand.

A copy of ``repro/obs/fpr.py`` (numpy only), reporting through the
port's metrics registry, with one change that keeps every output equal:
the insert stream's dedup and membership tests sort once and search
(:func:`_sorted_unique`, :func:`_member`) instead of calling
``np.unique`` / ``np.isin``, whose hash-based unique (numpy 2.3 and
later) made inserts with obs on 200 times slower than with it off on the
card's host (``chip_smoke.py`` phase 11).

A :class:`FprSampler` holds a fixed reservoir of *candidate* absent
point keys and ranges drawn uniformly over the filter's ``2^d`` code
domain.  Candidates are invalidated as the workload proves them present,
through either of two modes:

* **insert-stream tracking** (filter handles): ``observe_insert`` buffers
  every inserted code and lazily kills candidates the stream hits —
  amortised, never on the probe path;
* **ground truth** (the LSM store): ``mark_present`` *recomputes*
  liveness from the full live-key set at sample time — zero per-put
  overhead, exact by construction.

``sample()`` re-probes the surviving candidates through caller-supplied
probe closures; any positive is a certain false positive, so the hit
rate IS the live observed FPR.  ``observe_ranges`` additionally feeds
the query range-length distribution (``obs/workload/range_log2``
histogram + an Algorithm-R reservoir of raw bounds) — the workload
sample the Proteus-style tuner open item needs (ROADMAP, PAPERS.md).
"""
from __future__ import annotations

import numpy as np

from . import metrics as _metrics

# log2(range length) upper edges, 0..64: the whole dyadic ladder
LOG2_BUCKETS = tuple(float(b) for b in range(65))

#: the pinned ``sample()`` dict schema: always the first three, the two
#: FPR fields only when the matching probe ran.  ``bloomrf-workload/v1``
#: (repro.tune.workload) consumes these by name — additions are fine,
#: renames/removals are a schema break.
SAMPLE_FIELDS = ("point_candidates", "range_candidates", "workload_seen",
                 "point_fpr", "range_fpr")

_SETTLE_AT = 1 << 16        # pending inserted codes before a lazy settle


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique(a)`` of a 1-d array, by one sort."""
    a = np.sort(a)
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def _member(x: np.ndarray, sorted_set: np.ndarray) -> np.ndarray:
    """``np.isin(x, sorted_set)`` for a sorted, non-empty ``sorted_set``."""
    idx = np.searchsorted(sorted_set, x)
    at = np.minimum(idx, sorted_set.size - 1)
    return (idx < sorted_set.size) & (sorted_set[at] == x)


class FprSampler:
    """Reservoir of known-absent keys/ranges over a ``2^d`` code domain."""

    def __init__(self, d: int, n_keys: int = 512, n_ranges: int = 512,
                 range_len: int = 256, seed: int = 0xB10F,
                 reservoir_cap: int = 1024,
                 workload_hist: str = "obs/workload/range_log2"):
        if not 1 <= d <= 64:
            raise ValueError("d must be in [1, 64]")
        self.d = d
        self._rng = np.random.default_rng(seed)
        top = np.uint64((1 << d) - 1) if d < 64 else np.uint64(2**64 - 1)
        self.keys = self._rng.integers(0, 1 << d, n_keys, dtype=np.uint64)
        lo = self._rng.integers(0, 1 << d, n_ranges, dtype=np.uint64)
        with np.errstate(over="ignore"):
            hi = lo + np.uint64(max(range_len - 1, 0))
        self.lo = lo
        self.hi = np.where(hi < lo, top, np.minimum(hi, top))
        self.key_live = np.ones(n_keys, dtype=bool)
        self.range_live = np.ones(n_ranges, dtype=bool)
        self._pending: list[np.ndarray] = []
        self._pending_n = 0
        # workload reservoir (Algorithm R over (lo, hi) pairs)
        self._reservoir: list[tuple[int, int]] = []
        self._cap = reservoir_cap
        self._seen = 0
        self._hist = workload_hist
        # host copy of the range-length histogram: the tuner's workload
        # fit must not depend on the (off-by-default) metrics registry
        self.range_log2_counts = np.zeros(len(LOG2_BUCKETS))

    # -- candidate invalidation ------------------------------------------

    def observe_insert(self, codes) -> None:
        """Buffer inserted codes; candidates they hit die lazily."""
        codes = np.atleast_1d(np.asarray(codes, dtype=np.uint64))
        if codes.size == 0:
            return
        self._pending.append(codes)
        self._pending_n += codes.size
        if self._pending_n >= _SETTLE_AT:
            self._settle()

    def _settle(self) -> None:
        if not self._pending:
            return
        ins = _sorted_unique(np.concatenate(self._pending))
        self._pending, self._pending_n = [], 0
        self.key_live &= ~_member(self.keys, ins)
        idx = np.searchsorted(ins, self.lo)
        at = np.minimum(idx, max(ins.size - 1, 0))
        nonempty = (idx < ins.size) & (ins[at] <= self.hi)
        self.range_live &= ~nonempty

    def mark_present(self, present) -> None:
        """Recompute liveness from the FULL present-key set (ground
        truth); replaces — not merges with — insert-stream state."""
        present = _sorted_unique(np.asarray(present, dtype=np.uint64))
        self._pending, self._pending_n = [], 0
        if present.size == 0:
            self.key_live[:] = True
            self.range_live[:] = True
            return
        self.key_live = ~_member(self.keys, present)
        idx = np.searchsorted(present, self.lo)
        at = np.minimum(idx, present.size - 1)
        self.range_live = ~((idx < present.size) & (present[at] <= self.hi))

    # -- workload sampling -----------------------------------------------

    def observe_ranges(self, lo, hi) -> None:
        """Feed the range-length histogram + the bounds reservoir."""
        lo = np.atleast_1d(np.asarray(lo, dtype=np.uint64))
        hi = np.atleast_1d(np.asarray(hi, dtype=np.uint64))
        if lo.size == 0:
            return
        lengths = (hi - lo).astype(np.float64) + 1.0
        log_len = np.log2(np.maximum(lengths, 1.0))
        _metrics.registry().histogram(self._hist, LOG2_BUCKETS).observe_many(
            log_len)
        idx = np.clip(np.ceil(log_len), 0, len(LOG2_BUCKETS) - 1)
        self.range_log2_counts += np.bincount(
            idx.astype(np.int64), minlength=len(LOG2_BUCKETS))
        free = self._cap - len(self._reservoir)
        if free > 0:
            take = min(free, lo.size)
            self._reservoir.extend(
                zip(lo[:take].tolist(), hi[:take].tolist()))
            self._seen += take
            lo, hi = lo[take:], hi[take:]
        if lo.size:
            # exact Algorithm R, vectorized: the i-th item of the batch is
            # the (seen_i)-th of the stream and replaces a uniform slot of
            # [0, seen_i) when that slot lands inside the reservoir.  The
            # draws are independent across items, so batch processing is
            # distribution-identical to the one-at-a-time loop — each
            # candidate survives with probability cap/seen, exactly.
            counts = self._seen + np.arange(1, lo.size + 1)
            slots = (self._rng.random(lo.size) * counts).astype(np.int64)
            self._seen += lo.size
            hit = slots < self._cap
            for j, a, b in zip(slots[hit].tolist(), lo[hit].tolist(),
                               hi[hit].tolist()):
                self._reservoir[j] = (a, b)

    def workload_sample(self) -> list[tuple[int, int]]:
        """The reservoir of raw (lo, hi) query bounds (tuner input)."""
        return list(self._reservoir)

    @property
    def workload_seen(self) -> int:
        return self._seen

    def preload_workload(self, bounds, seen: int, log2_counts=None) -> None:
        """Re-seed the workload sample from a serialized snapshot
        (``bloomrf-workload/v1`` restore): the reservoir resumes with its
        prior candidates and stream position, so a reopened tuner does not
        cold-start through its hysteresis gate again."""
        bounds = [(int(a), int(b)) for a, b in bounds][: self._cap]
        if any(a > b for a, b in bounds):
            raise ValueError("preload_workload: lo > hi in bounds")
        self._reservoir = bounds
        self._seen = max(int(seen), len(bounds))
        if log2_counts is not None:
            counts = np.asarray(log2_counts, np.float64)
            if counts.shape != (len(LOG2_BUCKETS),) or (counts < 0).any():
                raise ValueError(
                    f"preload_workload: log2_counts must be "
                    f"{len(LOG2_BUCKETS)} non-negative counts")
            self.range_log2_counts = counts.copy()

    # -- re-probe ---------------------------------------------------------

    def live_points(self) -> np.ndarray:
        self._settle()
        return self.keys[self.key_live]

    def live_ranges(self) -> tuple[np.ndarray, np.ndarray]:
        self._settle()
        return self.lo[self.range_live], self.hi[self.range_live]

    def sample(self, point_probe=None, range_probe=None) -> dict:
        """Re-probe surviving candidates → live observed FPR.

        ``point_probe(keys)`` / ``range_probe(lo, hi)`` return a boolean
        verdict per query; every positive is a certain false positive.
        """
        out = {
            "point_candidates": int(self.live_points().size),
            "range_candidates": int(self.live_ranges()[0].size),
            "workload_seen": self.workload_seen,
        }
        if point_probe is not None and out["point_candidates"]:
            pos = np.asarray(point_probe(self.live_points()))
            out["point_fpr"] = float(pos.astype(bool).ravel().mean())
        if range_probe is not None and out["range_candidates"]:
            lo, hi = self.live_ranges()
            pos = np.asarray(range_probe(lo, hi))
            out["range_fpr"] = float(pos.astype(bool).ravel().mean())
        return out
