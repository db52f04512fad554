"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic mix
and its per-layer metrics are found by name through ``BENCHMARK.json``:
``perfbench/configs/<config>.json``, ``perfbench/traffic/<traffic>.json``
and ``perfbench/metrics/<metric>.py``.

A run:

1. **Set-up** (``setup_s``, from the CUDA context's start, after
   ``import torch``, which no change to the program can move): imports the
   program (its CUDA libraries build into ``build/repro_torch/`` on the
   first run of a checkout), draws the keys and the pool of batches on the
   card from ``--seed``, builds the filter through
   ``open_filter(FilterSpec(...)).insert(...)``, and warms up each
   operation at each of the pool's sizes.
2. **The window**: one caller in a closed loop drives the filter's
   ``FilterOps`` (``f.ops``) on its state, one pool batch at a time,
   cycling through the pool; a batch is done when ``synchronize()``
   returns.  The host's clock times each batch from its call to that
   return, each call to its own return (dispatch), and the window.  With
   ``--trace 1`` the loop then runs once more, for ``TRACE_SECONDS``,
   under ``torch.profiler``.
3. **The check** (``check.py``): the peak memory is read, then the
   reference works out the layout, the state and every answer again.
4. **The result**: the compared numbers beside their limits as the last
   lines of standard error, and one JSON line as the last line of standard
   output: the cell's end-to-end metrics with ``--trace 0``, its per-layer
   metrics with ``--trace 1``.

A run fails, printing no result, without a card, when the program cannot
be imported, or when ``jax`` or the JAX package ``repro`` has been loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "perfbench"
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: length of the traced window of a ``--trace 1`` run
TRACE_SECONDS = 5.0
#: seconds of the loop under the profiler before its traced window
PROFILER_WARMUP_S = 0.5
#: warm-up calls per operation and size
WARMUP = 3

# caches of anything compiled at run time stay in the checkout
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")

import torch  # noqa: E402

_T_TORCH = time.perf_counter()

from . import check, counts, trace, traffic  # noqa: E402


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list          # metric names this cell reports
    per_layer: list
    units: dict               # metric name -> unit


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(kind):
        return [m["name"] for m in bench[kind]
                if name in m.get("workloads", [name])]

    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    return Cell(name, config, mix, w["chips"], mine("end_to_end"),
                mine("per_layer"), units)


@dataclasses.dataclass
class Window:
    """What one pass of the closed loop recorded."""

    seconds: float
    batches: int
    ops: int
    batch_ms: list            # per batch, call to the synchronize's return
    dispatch_s: list          # per batch, call to return on the host
    counts: list              # batches run per pool entry


@dataclasses.dataclass
class Run:
    """What the per-layer metric readers (``metrics/<name>.py``) read."""

    cell: Cell
    peaks: dict               # this card's row of peaks.json, or {}
    window: Window            # the untraced window
    traced: Window | None = None
    trace: trace.TraceSummary | None = None
    work_bytes: list | None = None   # per pool entry (counts.py)


def drive(call, pool: list, seconds: float, device, answers: dict,
          stamps: list | None = None) -> Window:
    """The closed loop: pool batch ``j % len(pool)`` at step ``j`` until
    ``seconds`` have passed; keeps each pool entry's last answer.  The
    host's clock is read three times a batch: before the call, at its
    return and after the synchronize.  With ``stamps``, appends each
    batch's ``(call, return, synchronize, done)`` in wall-clock
    nanoseconds (``time_ns``, the profiler's clock) once the loop ends."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    clock = time.perf_counter_ns
    calls, rets, ends, keys = [], [], [], []
    limit = int(seconds * 1e9)
    t0 = clock()
    j = 0
    while True:
        k = j % len(pool)
        a = clock()
        out = call(k)
        b = clock()
        sync()
        end = clock()
        calls.append(a)
        rets.append(b)
        ends.append(end)
        keys.append(k)
        answers[k] = out
        j += 1
        if end - t0 >= limit:
            break
    if stamps is not None:
        off = time.time_ns() - clock()
        stamps.extend((a + off, b + off, b + off, e + off)
                      for a, b, e in zip(calls, rets, ends))
    runs = [0] * len(pool)
    for k in keys:
        runs[k] += 1
    ops = sum(n * b.size for n, b in zip(runs, pool))
    return Window((end - t0) / 1e9, j, ops,
                  [(e - a) / 1e6 for a, e in zip(calls, ends)],
                  [(b - a) / 1e9 for a, b in zip(calls, rets)], runs)


def _p95(values: list) -> float:
    """The nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)]


def read_metric(name: str, run: Run):
    """Load ``metrics/<name>.py`` and return its ``read(run)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def generator(seed: int, device) -> torch.Generator:
    """The run's one source of inputs: keys first, then the pool."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def _program(cell: Cell, keys: torch.Tensor, device):
    """The filter as a user builds it: ``open_filter`` then ``insert``."""
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch

    f = repro_torch.open_filter(repro_torch.FilterSpec(**cell.config["spec"]),
                                device=device)
    f.insert(keys.cpu().numpy().view("uint64"))
    if f.ops is None:
        raise RuntimeError(f"{cell.config['spec']} took the plain path: the "
                           f"benchmark drives the kernels' FilterOps")
    return f


def execute(cell: Cell, seed: int, seconds: float, traced: bool,
            device="cuda") -> tuple:
    """One run of ``cell`` on ``device``: returns ``(result, outcome,
    run)``, the result line's dict (without ``check``), the
    ``check.Outcome`` and what the metric readers read."""
    device = torch.device(device)
    stamps = [("start", _T0), ("import torch", _T_TORCH)]

    def stamp(what):
        if device.type == "cuda":
            torch.cuda.synchronize()
        stamps.append((what, time.perf_counter()))

    if device.type == "cuda":
        torch.cuda.init()
    stamp("CUDA start")
    gen = generator(seed, device)
    bits = traffic.domain_bits(cell.config)
    keys = traffic.make_keys(cell.config, cell.config["spec"]["n"], gen,
                             device)
    stamp("keys")
    f = _program(cell, keys, device)
    ops, state = f.ops, f.state
    stamp("open_filter and insert")
    pool = traffic.make_pool(cell.config, cell.traffic, keys, gen, device)
    built = {j: torch.zeros_like(state) for j, b in enumerate(pool)
             if b.kind == "insert"}

    def call(j):
        b = pool[j]
        if b.kind == "point":
            return ops.point(state, b.keys)
        if b.kind == "range":
            return ops.range(state, b.lo, b.hi)
        return ops.insert(built[j].zero_(), b.keys)

    firsts = {}
    for j, b in enumerate(pool):
        firsts.setdefault((b.kind, b.size), j)
    for j in firsts.values():
        for _ in range(WARMUP):
            call(j)
    stamp("pool and warm-up")
    setup_s = stamps[-1][1] - stamps[2][1]
    print("perfbench: set-up " + ", ".join(
        f"{w} {b - a:.3f} s" for (_, a), (w, b) in zip(stamps, stamps[1:])),
        file=sys.stderr)

    answers: dict = {}
    window = drive(call, pool, seconds, device, answers)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    peaks = json.loads((HERE / "peaks.json").read_text()).get(kind, {})
    run = Run(cell, peaks, window)
    if traced:
        run.traced, run.trace = _traced_window(call, pool, device, answers)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    t = time.perf_counter()
    outcome = check.compare(cell.config, bits, f.layout, keys, f.state, pool,
                            answers)
    print(f"perfbench: the check took {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    if traced:
        ref = check.reference(cell.config)
        lay = ref.layout(cell.config, bits)
        run.work_bytes = [counts.batch_bytes(lay, outcome.ref_state, b, ref)
                          for b in pool]
    result = {"correct": outcome.correct, "attempted": window.batches,
              "failed": outcome.failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        metrics = {m: read_metric(m, run) for m in cell.per_layer}
        if run.trace is not None:
            dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            result["breakdown"] = {"device_ops": run.trace.device_ops,
                                   "idle_gaps": run.trace.idle_gaps}
    else:
        e2e = {"setup_s": setup_s,
               "ops_per_s": window.ops / window.seconds,
               "batch_p95_ms": _p95(window.batch_ms),
               "fpr_pct": outcome.fpr_pct}
        metrics = {m: e2e[m] for m in cell.end_to_end}
    result["metrics"] = {m: {"value": v, "unit": cell.units[m]}
                         for m, v in metrics.items() if v is not None}
    result["device"] = dev
    return result, outcome, run


def _traced_window(call, pool, device, answers) -> tuple:
    """The loop once more under ``torch.profiler``, recording the device's
    activity and the CUDA calls that enqueue it (not the host's operators,
    whose recording would slow the host several-fold per batch)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    stamps: list = []
    with profile(activities=acts) as prof:
        # the profiler's own start-up stays out of the traced window, and
        # a pause keeps the warm-up's launch records clear of it
        drive(call, pool, PROFILER_WARMUP_S, device, answers)
        time.sleep(2 * trace.LAUNCH_MARGIN_NS / 1e9)
        w = drive(call, pool, TRACE_SECONDS, device, answers, stamps)
    return w, trace.summarize(trace.events_of(prof), stamps)


def _loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, outcome, run = execute(cell, args.seed, args.seconds,
                                   bool(args.trace))
    found = _loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    if run.trace is not None:
        out = BUILD / "traces" / f"{args.workload}.{args.seed}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"result": result,
                                   "trace": dataclasses.asdict(run.trace),
                                   "traced_batches": run.traced.batches},
                                  indent=1))
        if run.trace.records_missing:
            print(f"perfbench: {run.trace.records_missing} device records "
                  f"missing from the trace", file=sys.stderr)
    print(f"perfbench: {args.workload} seed {args.seed}: "
          f"{run.window.batches} batches in {run.window.seconds:.3f} s",
          file=sys.stderr)
    for name, (value, limit) in outcome.numbers.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    result["check"] = {name: {"value": v, "limit": lim}
                       for name, (v, lim) in outcome.numbers.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
