#!/usr/bin/env python3
"""How reliably a ``torch.profiler`` trace shows the kernel launches of the
port's partitioned wrappers (``range_probe_partitioned``,
``point_probe_partitioned``), on one NVIDIA card.

``chip_smoke.py`` phase 8 asserts one device operation per partitioned
wrapper call from such a trace.  This script repeats that trace many times
on a state of phase 8's first size (12,500,000 lanes, random bits; the
verdicts do not matter here) at 262,144 queries, and for every trace
records:

* the wrapper's own launch count over the call;
* the host-side launch records the trace holds (CUPTI's callbacks on
  the CUDA API: names holding ``Launch``), with their correlation ids;
* the device records (kernels, copies, sets) whose correlation id matches
  each launch, and the device records that match none.

It prints one JSON line: for each wrapper, how many traces (of
``--traces``) missed a device record, at which call index, and whether
the missing record's host launch was in the trace; also what
``prof.events()`` (the view ``chip_smoke.py`` counts) held.  It imports
neither ``jax`` nor ``repro``::

    python3 benchmarks/torch_trace_launches.py --traces 200
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_trace(fn, reps: int, launches) -> dict:
    """``reps`` calls of ``fn`` in one trace, as ``chip_smoke._device_busy``
    takes it (a warm-up call and a synchronize before the window).  The
    i-th host-side launch record is call i's (each call launches once, by
    the wrapper's own count); device records join their launch by
    correlation id."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counted = launches() - before
    raw = prof.profiler.kineto_results.events()
    host = sorted((e for e in raw if e.device_type() == DeviceType.CPU
                   and "Launch" in e.name()), key=lambda e: e.start_ns())
    device = [e for e in raw if e.device_type() != DeviceType.CPU]
    dev_corr = collections.Counter(e.correlation_id() for e in device)
    host_corr = {e.correlation_id() for e in host}
    legacy = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    return {"counted": counted, "host_launches": len(host),
            "device_records": len(device),
            "device_per_launch": [dev_corr[e.correlation_id()]
                                  for e in host],
            "orphan_device_records": sorted(
                e.name()[:40] for e in device
                if e.correlation_id() not in host_corr),
            "events_view_device_ops": legacy}


def summarise(traces: list, reps: int) -> dict:
    """Counts over all traces; the traces that differ from one host launch
    and one device record per call are kept whole."""
    odd = [t for t in traces
           if t["events_view_device_ops"] != reps
           or t["device_records"] != reps or t["host_launches"] != reps
           or t["device_per_launch"] != [1] * reps]
    return {
        "traces": len(traces),
        "wrapper_launches_per_trace": sorted({t["counted"] for t in traces}),
        "events_view_device_ops": dict(collections.Counter(
            t["events_view_device_ops"] for t in traces)),
        "device_records": dict(collections.Counter(
            t["device_records"] for t in traces)),
        "host_launches": dict(collections.Counter(
            t["host_launches"] for t in traces)),
        "odd_traces": odd[:20], "n_odd": len(odd),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=200)
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs    # puts this tree's src first on the path
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_launches: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import basic_layout
    from repro_torch.kernels import (point_probe_partitioned,
                                     range_probe_partitioned)

    device = torch.device("cuda")
    lay = basic_layout(32, cs.HBM_KEYS, 16.0, delta=7)
    rng = np.random.default_rng(cs.SEED)
    state = torch.randint(-(1 << 31), 1 << 31, (lay.total_u32,),
                          dtype=torch.int32, device=device)
    pq, lo, hi = cs._queries(rng, cs.CHUNK,
                             rng.integers(0, 1 << 32, 1000, dtype=np.uint64),
                             (1 << 32) - 1)
    tq, tlo, thi = (cs._i64(a, device) for a in (pq, lo, hi))
    out = {"card": cs._smi(), "torch": torch.__version__,
           "reps": args.reps}
    calls = {"point_part": (lambda: point_probe_partitioned(lay, state, tq),
                            point_probe_partitioned),
             "range_part": (lambda: range_probe_partitioned(lay, state, tlo,
                                                            thi),
                            range_probe_partitioned)}
    # as in chip_smoke.py phase 8: a point trace, then a range trace, in
    # one process; the second half after each wrapper's CUDA-graph timing
    for graphs in (False, True):
        traces = {k: [] for k in calls}
        for _ in range(args.traces):
            for name, (fn, wrapper) in calls.items():
                if graphs:
                    cs._graph_ms(fn, reps=4, replays=2)
                traces[name].append(one_trace(
                    fn, args.reps, lambda w=wrapper: w.launches))
        for name in calls:
            out[f"{name}{'_after_graphs' if graphs else ''}"] = summarise(
                traces[name], args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
