"""Span tracing: host-side timing contexts around production paths.

Counterpart of ``repro/obs/trace.py``.  ``span(name)`` returns a context
manager.  With observability disabled it is a shared do-nothing
singleton: one boolean check, zero allocation.  Enabled, a span:

* wraps the body in ``torch.profiler.record_function("bloomrf/<name>")``,
  so the op shows up in a ``torch.profiler`` trace when a session is
  active, and, where CUDA is present, in an NVTX range of the same name
  (``torch.cuda.nvtx.range_push``/``range_pop``) for external profilers;
* feeds the wall-clock duration into the per-op-class latency histogram
  ``obs/latency/{name}`` in the global registry (p50/p99 come from
  there); and
* appends a structured ``bloomrf-trace/v1`` JSONL record when a trace
  sink has been set via :func:`set_trace_sink`.

Spans are HOST-side only: they launch nothing on the device and never
synchronise it, so a path's kernel launches are the same with
observability on or off.  Under an active ``torch.profiler`` session a
``record_function`` range can add a record of its own to the trace, which
is why the launch checks count the kernel wrappers' own counters.
"""
from __future__ import annotations

import json
import time

import torch

from . import metrics as _metrics

TRACE_SCHEMA = "bloomrf-trace/v1"

_sink_path: str | None = None
_sink_file = None
_nvtx: bool | None = None       # resolved on the first enabled span


def set_trace_sink(path: str | None) -> None:
    """Append JSONL span records to ``path`` (``None`` closes the sink)."""
    global _sink_path, _sink_file
    if _sink_file is not None:
        _sink_file.close()
    _sink_path, _sink_file = None, None
    if path:
        _sink_path = str(path)
        _sink_file = open(path, "a", encoding="utf-8")


def trace_sink() -> str | None:
    return _sink_path


class _NullSpan:
    """Disabled-mode span: a do-nothing context-manager singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("name", "attrs", "_t0", "_prof")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._prof = None

    def __enter__(self):
        global _nvtx
        if _nvtx is None:
            _nvtx = torch.cuda.is_available()
        label = f"bloomrf/{self.name}"
        self._prof = torch.profiler.record_function(label)
        self._prof.__enter__()
        if _nvtx:
            torch.cuda.nvtx.range_push(label)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur_us = (time.perf_counter() - self._t0) * 1e6
        if _nvtx:
            torch.cuda.nvtx.range_pop()
        self._prof.__exit__(*exc)
        _metrics.registry().histogram(
            f"obs/latency/{self.name}").observe(dur_us)
        if _sink_file is not None:
            rec = {"schema": TRACE_SCHEMA, "span": self.name,
                   "ts": time.time(), "dur_us": dur_us}
            if self.attrs:
                rec["attrs"] = self.attrs
            _sink_file.write(json.dumps(rec) + "\n")
            _sink_file.flush()
        return False


def span(name: str, **attrs):
    """Span context for op-class ``name``; a no-op singleton when off."""
    if not _metrics.enabled():
        return NULL_SPAN
    return Span(name, attrs)
