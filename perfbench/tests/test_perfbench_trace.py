"""Reading a traced window, on records made up by hand."""
from __future__ import annotations

import pytest

from perfbench import trace

K = "(anonymous namespace)::insert_kernel(long const*, long)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor>"


def _window(offset=0):
    """Two batches, each a fill and a kernel: the host's stamps (call,
    return, synchronize, done) ``offset`` ns behind the trace's clock."""
    stamps = [tuple(t - offset for t in st)
              for st in [(0, 20, 30, 80), (100, 120, 130, 200)]]
    events = [("cudaLaunchKernel", False, 10, 11, 4), (FILL, True, 12, 14, 4),
              ("cudaLaunchKernel", False, 18, 19, 1), (K, True, 25, 70, 1),
              ("cudaLaunchKernel", False, 110, 111, 2),
              (FILL, True, 112, 115, 2),
              ("cudaLaunchKernel", False, 118, 119, 3), (K, True, 125, 180, 3)]
    return events, stamps


def test_busy_window_and_kernels():
    t = trace.summarize(*_window())
    assert t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx((2 + 45 + 3 + 55) * 1e-9)
    assert t.program_kernel_s == pytest.approx(100e-9)
    assert t.program_kernels == 2 and t.records_missing == 0
    assert t.device_ops[0] == [K, pytest.approx(100e-9)]


@pytest.mark.parametrize("offset", [0, 7])
def test_idle_gaps_by_what_the_host_did(offset):
    """The stamps move onto the trace's clock by the last launch of each
    batch against its return (-1 ns here); each gap is split by what the
    host was doing: -1..12, 14..19, 99..112, 115..119 in a call; 19..25,
    79..99, 119..125 in the loop; 70..79, 180..199 in a synchronize."""
    t = trace.summarize(*_window(offset))
    assert t.clock_offset_us == pytest.approx((offset - 1) * 1e-3)
    assert dict(t.idle_gaps) == {
        "host in the program's call": pytest.approx(35e-9),
        "host in the benchmark's loop": pytest.approx(32e-9),
        "host in torch.cuda.synchronize": pytest.approx(28e-9)}


def test_a_missing_device_record_scales_the_kernel_time():
    events, stamps = _window()
    events = [e for e in events if not (e[1] and e[4] == 1)]
    t = trace.summarize(events, stamps)
    assert t.records_missing == 1
    assert t.program_kernel_s == pytest.approx(55e-9 * 4 / 3)


def test_launches_before_the_window_are_not_its_own():
    events, stamps = _window()
    early = ("cudaLaunchKernel", False, -2 * trace.LAUNCH_MARGIN_NS,
             -2 * trace.LAUNCH_MARGIN_NS + 1, 9)
    assert trace.summarize([early] + events, stamps).clock_offset_us \
        == pytest.approx(-1e-3)


def test_launches_that_do_not_divide_leave_gaps_unattributed():
    events, stamps = _window()
    t = trace.summarize(events[1:], stamps)
    assert t.clock_offset_us is None
    assert dict(t.idle_gaps).keys() == {"unattributed"}


def test_nothing_to_read():
    events, stamps = _window()
    assert trace.summarize([e for e in events if not e[1]], stamps) is None
    assert trace.summarize(events, []) is None
