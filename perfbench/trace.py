"""Reading the traced window.

A ``--trace 1`` run drives the cell's loop once more under
``torch.profiler``, recording the device's operations and the CUDA calls
that enqueue them, while the loop stamps each batch on the host's wall
clock (the profiler's clock): before the call into the program, at its
return, before the ``torch.cuda.synchronize()`` and after it.  From these
this module takes:

* ``window_s``: from the first batch's call to the last batch's return
  from its synchronize, on the trace's clock (below);
* ``busy_s``: the time inside it in which any device operation ran (the
  union of the device records);
* ``program_kernel_s``: the device time of the program's own kernels, the
  kernels that are neither copies, fills nor PyTorch's (whose names hold
  ``at::``), wherever they were launched from; where the trace holds a
  launch whose device record never arrived (CUPTI delivers them apart),
  the time is scaled by launches over records received, and the count is
  kept in ``records_missing``;
* ``device_ops``: device time by operation name, longest first;
* ``idle_gaps``: the device's idle time inside the window by what the
  host was doing meanwhile (in the program's call, in the synchronize, or
  in the benchmark's own loop), longest first.  The host's
  stamps are first moved onto the trace's clock: each batch's last kernel
  launch record (the profiler's) ends just before the call returns (the
  host's stamp), and the median of the differences is the offset
  (``clock_offset_us``).  Where the launches do not divide evenly among
  the batches, the gaps go unattributed.
"""
from __future__ import annotations

import bisect
import dataclasses
import re

__all__ = ["TraceSummary", "summarize", "events_of"]

_ENQUEUE = re.compile(r"^cu(da)?(Launch|Memcpy|Memset)")
_LAUNCH = re.compile(r"^cu(da)?Launch")
#: launch records this close to the window count as the window's
LAUNCH_MARGIN_NS = 5_000_000
_TOP = 10


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    program_kernel_s: float
    program_kernels: int
    records_missing: int
    clock_offset_us: float | None
    device_ops: list
    idle_gaps: list


def events_of(prof) -> list:
    """``(name, on_device, start_ns, end_ns, correlation_id)`` of every
    record of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(),
             e.end_ns(), e.correlation_id())
            for e in prof.profiler.kineto_results.events()]


def _is_program_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset")) and "at::" not in name


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


_CALL, _SYNC, _LOOP = ("host in the program's call",
                       "host in torch.cuda.synchronize",
                       "host in the benchmark's loop")


def _split(stamps: list, starts: list, a: int, b: int, into: dict) -> None:
    """Add the idle interval ``[a, b)`` to ``into`` by what the loop was
    doing: in a call, in a synchronize, or else in the loop."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    phases = 0
    while i < len(stamps) and stamps[i][0] < b:
        call, ret, sync0, end = stamps[i]
        for what, lo, hi in ((_CALL, call, ret), (_SYNC, sync0, end)):
            n = min(b, hi) - max(a, lo)
            if n > 0:
                into[what] = into.get(what, 0) + n
                phases += n
        i += 1
    into[_LOOP] = into.get(_LOOP, 0) + (b - a) - phases


def _clock_offset(events: list, stamps: list) -> int | None:
    """The trace's clock minus the host's stamps, in ns, from each batch's
    last launch record against its return (None where the launches in the
    window do not divide evenly among the batches)."""
    lo, hi = stamps[0][0] - LAUNCH_MARGIN_NS, stamps[-1][3] + LAUNCH_MARGIN_NS
    ends = sorted(e for n, dev, s, e, _ in events
                  if not dev and _LAUNCH.match(n) and lo <= s <= hi)
    per, rest = divmod(len(ends), len(stamps))
    if not per or rest:
        return None
    diffs = sorted(ends[per * i + per - 1] - st[1]
                   for i, st in enumerate(stamps))
    return diffs[len(diffs) // 2]


def summarize(events: list, stamps: list) -> TraceSummary | None:
    """The summary of one traced window (``stamps``: per batch, the host's
    ``(call, return, synchronize, done)`` wall-clock ns), or None when no
    device record falls inside it."""
    if not stamps:
        return None
    offset = _clock_offset(events, stamps)
    if offset is not None:
        stamps = [tuple(t + offset for t in st) for st in stamps]
    w0, w1 = stamps[0][0], stamps[-1][3]
    device = [(n, max(s, w0), min(e, w1), c) for n, dev, s, e, c in events
              if dev and e > w0 and s < w1]
    if not device:
        return None
    busy = _union([(s, e) for _, s, e, _ in device])
    by_name: dict = {}
    for n, s, e, _ in device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    kernels = [(e - s) for n, s, e, _ in device if _is_program_kernel(n)]
    enqueued = {c for n, dev, s, e, c in events
                if not dev and w0 <= s <= w1 and _ENQUEUE.match(n)}
    missing = len(enqueued - {c for _, _, _, c in device})
    received = sum(1 for n, _, _, _ in device
                   if not n.startswith(("Memcpy", "Memset")))
    scale = (received + missing) / received if received else 1.0

    gaps: dict = {}
    starts = [st[0] for st in stamps]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if offset is None:
            gaps["unattributed"] = gaps.get("unattributed", 0) + (b - a)
        else:
            _split(stamps, starts, a, b, gaps)
    top = lambda d: [[k, v / 1e9] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:_TOP]]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        program_kernel_s=sum(kernels) * scale / 1e9,
        program_kernels=len(kernels), records_missing=missing,
        clock_offset_us=None if offset is None else offset / 1e3,
        device_ops=[[k[:120], v] for k, v in top(by_name)],
        idle_gaps=top(gaps))
