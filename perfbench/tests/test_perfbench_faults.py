"""A run with the timed path broken underneath comes out not correct, and
so does the control: the comparison has been seen to fail.

Each cell runs here at a small size on the CPU, skipping the look for a
card (``run.execute`` on ``"cpu"``); ``FilterOps`` there takes its plain
versions.  The faults are the ones a filter cell can have: a build that
returns its state unchanged, half of a batch left out, one answer altered
where it is produced."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, run

#: each cell at a size a test run holds: (spec n, batch, pool, backend)
SMALL = {"fig11-u32-1m.ranges": (20_000, 2_048, 2, "resident"),
         "fig11-u32-1m.points": (20_000, 2_048, 2, "resident"),
         "fig11-u32-1m.build": (20_000, 5_000, 2, "resident")}
SEED = 2**32 + 3


def small(name: str) -> run.Cell:
    cell = run.load_cell(name)
    n, batch, pool, backend = SMALL[name]
    cell.config["spec"].update(n=n, backend=backend)
    cell.traffic.update(batch=batch, pool=pool)
    return cell


def _run(name):
    res, out, _ = run.execute(small(name), SEED, 0.2, False, device="cpu")
    return res, out


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_unbroken_run_is_correct(name):
    res, out = _run(name)
    assert res["correct"] and out.correct and res["failed"] == 0
    assert set(res["metrics"]) == set(run.load_cell(name).end_to_end)


def _half(fn):
    def broken(self, state, *args):
        n = args[0].numel() // 2
        out = fn(self, state, *(a[:n] for a in args))
        if out.dtype == torch.bool:
            return torch.cat([out, torch.zeros(args[0].numel() - n,
                                               dtype=torch.bool)])
        return out
    return broken


def _altered(fn):
    def broken(self, *args):
        out = fn(self, *args).clone()
        out[0] = ~out[0] if out.dtype == torch.bool else out[0] ^ 1
        return out
    return broken


def _unchanged(fn):
    return lambda self, state, keys: state


PROBE = [("fig11-u32-1m.ranges", "range"), ("fig11-u32-1m.points", "point")]
FAULTS = [(c, op, f) for c, op in PROBE for f in (_half, _altered)] + [
    ("fig11-u32-1m.build", "insert", f) for f in (_half, _altered, _unchanged)]


@pytest.mark.parametrize("name,op,fault", FAULTS,
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, op, fault):
    from repro_torch.kernels.ops import FilterOps

    monkeypatch.setattr(FilterOps, op, fault(getattr(FilterOps, op)))
    res, out = _run(name)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("which", control.CONTROLS)
def test_the_control_is_not_correct(name, which):
    out = control.control_outcome(small(name), SEED, which, device="cpu")
    assert not out.correct
