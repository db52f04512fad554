"""``dispatch_us``: the median host microseconds from a call into the
program (``FilterOps.point``, ``.range``, or a state's ``zero_`` and
``FilterOps.insert``) to its return, before the synchronize, over the
batches of the run's untraced window (the benchmark's own timers).  The
median is a steady statistic of the dispatch layer beside the window's
tail, ``batch_p95_ms``."""
import statistics


def read(run):
    d = run.window.dispatch_s
    return statistics.median(d) * 1e6 if d else None
