"""``device_idle_pct``: the share of the traced window in which no
operation ran on the device, from the ``torch.profiler`` timeline
(``trace.summarize``'s ``busy_s`` over ``window_s``).  Nothing when the
trace holds no device record."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
