"""``kernels_roofline``: the least time the card's memory bandwidth
allows for the traced window's work, as a share of the device time of the
program's kernels in that window.

The work is ``counts.py``'s count of each pool batch (keys at their
domain's width, a byte a verdict, the distinct 32-byte state sectors the
answers need), times the batches the traced window ran of it; the
bandwidth is the card's row of ``peaks.json``.  Every operation of a
bloomRF filter is integer work, so bytes bound it.  Nothing when the card
has no row, or the trace holds no kernel of the program."""


def read(run):
    bw = run.peaks.get("hbm_bytes_per_s")
    t = run.trace
    if not bw or t is None or t.program_kernel_s <= 0 \
            or run.work_bytes is None:
        return None
    work = sum(n * w for n, w in zip(run.traced.counts, run.work_bytes))
    return 100.0 * work / bw / t.program_kernel_s
