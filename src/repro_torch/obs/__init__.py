"""Observability plane: metrics, spans and live FPR telemetry.

Counterpart of ``repro.obs``.  Three layers, one registry:

* :mod:`repro_torch.obs.metrics` — counters / gauges / fixed-bucket
  histograms with device-scalar accumulation (no host sync until
  ``snapshot()``), plus registered *families* (``StoreStats``) that keep
  their own field access;
* :mod:`repro_torch.obs.trace` — host-side spans around façade / store /
  WAL / compaction / kernel-dispatch ops: ``torch.profiler`` and NVTX
  ranges, ``bloomrf-trace/v1`` JSONL when a sink is set, p50/p99 latency
  histograms always;
* :mod:`repro_torch.obs.fpr` — known-absent reservoirs whose re-probe
  yields the *live* observed FPR and the query range-length distribution.

Everything is off by default (``BLOOMRF_OBS=1`` or :func:`enable`); with
it off every instrumentation site is one boolean check, and with it on
the kernel launches of every path are unchanged (spans launch nothing).
``export_snapshot()`` emits the ``bloomrf-metrics/v1`` document.
"""
from .fpr import FprSampler
from .metrics import (DEFAULT_LATENCY_BUCKETS_US, Counter, Gauge, Histogram,
                      MetricsRegistry, disable, enable, enabled, registry)
from .trace import TRACE_SCHEMA, set_trace_sink, span, trace_sink

METRICS_SCHEMA = "bloomrf-metrics/v1"


def export_snapshot(extra: dict | None = None) -> dict:
    """Materialise the registry once -> a ``bloomrf-metrics/v1`` dict."""
    snap = registry().snapshot()
    if extra:
        snap.update(extra)
    return {"schema": METRICS_SCHEMA, "metrics": snap}


__all__ = [
    "DEFAULT_LATENCY_BUCKETS_US", "Counter", "FprSampler", "Gauge",
    "Histogram", "METRICS_SCHEMA", "MetricsRegistry", "TRACE_SCHEMA",
    "disable", "enable", "enabled", "export_snapshot", "registry",
    "set_trace_sink", "span", "trace_sink",
]
