"""Metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``repro/obs/metrics.py``, with the same names, semantics
and snapshot form.  Three rules keep the registry safe to wire through hot
paths:

* **Device-scalar accumulation.**  ``Counter.add`` / ``Gauge.set`` accept
  torch tensors (on the card or the CPU) and only *stash* them: nothing
  blocks, nothing is copied to the host.  ``snapshot()`` settles every
  pending tensor once, at the read point (the pending values are summed on
  their device and read back with one transfer), so timed loops never pay
  a host sync for telemetry.
* **Disabled by default.**  The global flag (``BLOOMRF_OBS`` env var, or
  :func:`enable`/:func:`disable`) gates every instrumentation *site*;
  with it off the production paths do one boolean check and move on.
  The registry itself always works: the flag guards the call sites, not
  the data structures.
* **Families, not forks.**  Existing ad-hoc counters (``StoreStats``) keep
  their own field access; they join the registry as *registered
  families*: zero-arg callables returning a plain dict, weakly referenced
  by the caller so a dead owner drops out of the next snapshot.

Metric names use ``/`` separators (``store/puts``, ``obs/fpr/observed``).
"""
from __future__ import annotations

import math
import os
from typing import Callable, Iterable

# default latency ladder (microseconds): ~log-spaced 1us..1s
DEFAULT_LATENCY_BUCKETS_US = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1e3, 2e3, 5e3, 1e4, 2e4, 5e4, 1e5, 2e5, 5e5, 1e6,
)

_ENABLED = os.environ.get("BLOOMRF_OBS", "").lower() in ("1", "true", "yes", "on")


def enabled() -> bool:
    """Is the observability plane on?  Call sites gate on this."""
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def _is_host_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class Counter:
    """Monotone counter; ``add`` never syncs a device value."""

    kind = "counter"
    __slots__ = ("name", "_host", "_pending")

    def __init__(self, name: str):
        self.name = name
        self._host = 0.0
        self._pending: list = []

    def add(self, v=1) -> None:
        if _is_host_number(v):
            self._host += v
        else:                       # tensor or numpy scalar: settle lazily
            self._pending.append(v)

    def _settle(self) -> None:
        if self._pending:
            total = self._pending[0]
            for x in self._pending[1:]:
                total = total + x   # device-side adds, one transfer below
            self._pending = []
            self._host += float(total)

    def value(self):
        self._settle()
        v = self._host
        return int(v) if float(v).is_integer() else v

    def reset(self) -> None:
        self._host, self._pending = 0.0, []

    def snapshot_value(self):
        return self.value()


class Gauge:
    """Last-write-wins value; device scalars settle at snapshot time."""

    kind = "gauge"
    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v) -> None:
        self._value = v             # device scalar kept as-is (no sync)

    def value(self) -> float:
        if not _is_host_number(self._value):
            self._value = float(self._value)
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot_value(self):
        return self.value()


class Histogram:
    """Fixed-bucket histogram (host-side observations).

    ``buckets`` are ascending upper edges; one implicit overflow bucket
    catches everything above the last edge.  Percentiles report the upper
    edge of the covering bucket (overflow clamps to the last edge), which
    is conservative and cheap: good enough for p50/p99 latency gates.
    """

    kind = "histogram"
    __slots__ = ("name", "buckets", "counts", "total", "count")

    def __init__(self, name: str,
                 buckets: tuple = DEFAULT_LATENCY_BUCKETS_US):
        if list(buckets) != sorted(buckets) or not buckets:
            raise ValueError("histogram buckets must be ascending and non-empty")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for edge in self.buckets:
            if v <= edge:
                break
            i += 1
        self.counts[i] += 1
        self.total += v
        self.count += 1

    def observe_many(self, values: Iterable[float]) -> None:
        import numpy as np

        arr = np.asarray(list(values) if not hasattr(values, "__len__")
                         else values, dtype=np.float64).ravel()
        if arr.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.buckets), arr, side="left")
        # a bincount, not np.unique(return_counts=True): the same counts
        # without numpy's hash-based unique (see obs/fpr.py)
        for i, c in enumerate(np.bincount(idx, minlength=len(self.counts))):
            self.counts[i] += int(c)
        self.total += float(arr.sum())
        self.count += int(arr.size)

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        need = math.ceil(q * self.count)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= need:
                return self.buckets[min(i, len(self.buckets) - 1)]
        return self.buckets[-1]

    def reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.total, self.count = 0.0, 0

    def snapshot_value(self) -> dict:
        mean = self.total / self.count if self.count else 0.0
        return {"count": self.count, "mean": mean,
                "p50": self.percentile(0.50), "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Name -> metric map plus registered families.

    A *family* is a zero-arg callable returning a flat dict (or ``None``
    once its owner is gone: dead families are pruned at snapshot time).
    Family keys flatten into the snapshot as ``{family}/{key}``.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._families: dict[str, Callable[[], dict | None]] = {}

    def _get(self, name: str, cls, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: tuple | None = None) -> Histogram:
        if buckets is None:
            return self._get(name, Histogram)
        return self._get(name, Histogram, buckets=buckets)

    def register_family(self, name: str,
                        fn: Callable[[], dict | None]) -> str:
        """Register ``fn`` under ``name`` (suffixed ``#2``, ``#3``... if
        taken); returns the assigned name."""
        assigned, i = name, 1
        while assigned in self._families:
            i += 1
            assigned = f"{name}#{i}"
        self._families[assigned] = fn
        return assigned

    def unregister_family(self, name: str) -> None:
        self._families.pop(name, None)

    def snapshot(self) -> dict:
        """Flat dict of every metric value; the ONE host-sync point."""
        out = {}
        for name in sorted(self._metrics):
            out[name] = self._metrics[name].snapshot_value()
        for fam in sorted(self._families):
            vals = self._families[fam]()
            if vals is None:                  # owner collected: prune
                del self._families[fam]
                continue
            for k, v in vals.items():
                out[f"{fam}/{k}"] = v
        return out

    def reset(self) -> None:
        """Zero every metric; registered families are left alone."""
        for m in self._metrics.values():
            m.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every instrumentation site feeds."""
    return _REGISTRY
