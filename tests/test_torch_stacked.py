"""The port's plain ``StackedProbe`` and the store-scan wrapper on CPU tensors
against ``repro``'s ``StackedProbe`` (its jit'd XLA path), exactly.

The six run-stack classes of tests/test_store_scan_kernel.py: mixed Δ,
several segments, replicas, a promoted (tiled) state, the capacity-class
ladder and TTL generation lanes.  The promoted and TTL states are built
with the reference's ``core/dynamic.py`` and carried across as numpy, so
the port needs no ``dynamic`` module for them.  Each class is built once
per module and each reference probe compiles once, to keep the file cheap.
The CUDA launches are tested in tests/test_torch_gpu.py, on a card."""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FilterLayout as JLayout
from repro.core import basic_layout as jbasic
from repro.core.dynamic import Generations, promote_layout, promote_state
from repro.core.engine import _filter_for_layout as j_filter
from repro.core.engine import stacked_probe as j_stacked
from repro_torch.core import FilterLayout, stacked_probe
from repro_torch.core.engine import _filter_for_layout
from repro_torch.kernels import (FilterOps, build_run_stack,
                                 point_probe_stacked_resident,
                                 range_probe_stacked_resident,
                                 store_scan_probe, store_scan_probe_flat)

D = 32
DMAX = (1 << D) - 1
_CPU = torch.device("cpu")


def _port(jl) -> FilterLayout:
    return FilterLayout.from_dict(dataclasses.asdict(jl))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def _lanes(state) -> torch.Tensor:
    return torch.from_numpy(np.asarray(state, np.uint32).view(np.int32).copy())


# ---------------------------------------------------------------------------
# the six classes, built with the reference: (layouts, states, kmin, kmax)
# ---------------------------------------------------------------------------

def _insert(jl, state, keys) -> np.ndarray:
    """OR ``keys`` into a uint32 state with the port's insert, which equals
    the reference's bit for bit (tests/test_torch_core.py) and costs no
    JAX compile."""
    f = _filter_for_layout(_port(jl), _CPU)
    return f.insert(_lanes(state), _t(keys)).numpy().view(np.uint32)


def _filled_rows(layouts, rng, n_per=400):
    states, kmins, kmaxs = [], [], []
    for lay in layouts:
        keys = rng.integers(0, DMAX, n_per, dtype=np.uint64)
        states.append(_insert(lay, np.zeros(lay.total_u32, np.uint32), keys))
        kmins.append(int(keys.min()))
        kmaxs.append(int(keys.max()))
    return list(layouts), states, kmins, kmaxs


def _mixed_delta(rng):
    return _filled_rows([jbasic(D, 500, 12.0, delta=dl) for dl in (4, 6, 7)],
                        rng)


def _multi_segment(rng):
    seg = JLayout(d=D, deltas=(6, 5, 4), replicas=(1, 1, 1),
                  seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096))
    return _filled_rows([seg, jbasic(D, 400, 12.0, delta=6), seg], rng)


def _replicas(rng):
    rep = JLayout(d=D, deltas=(7, 7), replicas=(1, 2), seg_of_layer=(0, 0),
                  seg_bits=(16384,))
    return _filled_rows([rep, rep, jbasic(D, 300, 14.0, delta=7)], rng)


def _promoted(rng):
    base = jbasic(D, 400, 12.0, delta=6)
    big = promote_layout(base, 4)
    keys = rng.integers(0, DMAX, 800, dtype=np.uint64)
    small = jnp.asarray(_insert(base, np.zeros(base.total_u32, np.uint32),
                                keys))
    lays, states, kmins, kmaxs = _filled_rows(
        [jbasic(D, 1600, 12.0, delta=6)], rng)
    return ([big] + lays,
            [np.asarray(promote_state(small, base, big))] + states,
            [int(keys.min())] + kmins, [int(keys.max())] + kmaxs)


def _capacity_ladder(rng):
    c0 = jbasic(D, 400, 14.0, delta=6)
    return _filled_rows([c0, c0, jbasic(D, 1600, 14.0, delta=6),
                         jbasic(D, 6400, 14.0, delta=6)], rng)


def _ttl_lanes(rng):
    lay = jbasic(D, 600, 12.0, delta=6)
    gens = Generations(j_filter(lay).init_state, n_generations=3)
    keys = rng.integers(0, DMAX, 600, dtype=np.uint64)
    for part in np.array_split(keys, 4):
        gens.insert(lambda st, k: jnp.asarray(_insert(lay, st, k)), part)
        gens.advance()
    lays, states, kmins, kmaxs = _filled_rows(
        [jbasic(D, 500, 12.0, delta=5)], rng)
    return ([lay] + lays, [np.asarray(gens.collapsed)] + states,
            [int(keys.min())] + kmins, [int(keys.max())] + kmaxs)


CLASSES = {
    "mixed_delta": _mixed_delta,
    "multi_segment": _multi_segment,
    "replicas": _replicas,
    "promoted": _promoted,
    "capacity_ladder": _capacity_ladder,
    "ttl_lanes": _ttl_lanes,
}


def _reference(jlays, bases, flat, kmin, kmax, lo, hi, quar):
    """The reference's fence, touch, range and point verdicts.  The range
    verdicts come from a second ``touch_all`` call whose fences span the
    whole domain and whose mask is clear (``touch`` is then the verdict
    itself), so each stack compiles one touch and one point probe."""
    jp = j_stacked(tuple(jlays), bases)
    flat = jnp.asarray(flat)
    ju = lambda a: jnp.asarray(a, jnp.uint32)  # noqa: E731
    R = len(jlays)
    fence, touch = jp.touch_all(flat, ju(kmin), ju(kmax), ju(lo), ju(hi),
                                jnp.asarray(quar))
    everywhere, verdict = jp.touch_all(flat, ju(np.zeros(R)),
                                       ju(np.full(R, DMAX)), ju(lo), ju(hi),
                                       jnp.zeros(R, bool))
    assert np.asarray(everywhere).all()
    return {"fence": np.asarray(fence), "touch": np.asarray(touch),
            "range": np.asarray(verdict),
            "point": np.asarray(jp.point_all(flat, ju(lo)))}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """One class's rows, queries, quarantine mask and the reference's
    answers (each reference probe compiled once)."""
    rng = np.random.default_rng(0x57AC + sorted(CLASSES).index(name))
    jlays, states, kmin, kmax = CLASSES[name](rng)
    R, B = len(jlays), 200
    lo = rng.integers(0, DMAX, B, dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 20, B, dtype=np.uint64), DMAX)
    lo[:8] = hi[:8] = 0                     # below every fence
    lo[8:16] = hi[8:16] = DMAX              # above most fences
    lo[16:20], hi[16:20] = DMAX, 0          # swapped, the whole domain
    lo[20:24] = hi[20:24] = kmin[0]         # lo = hi on a fence
    lo[24:28], hi[24:28] = kmax[0] + 1, DMAX   # just off the first fence
    quar = np.zeros(R, bool)
    quar[R // 2] = True
    bases = tuple(int(b) for b in np.cumsum([0] + [len(s) for s in states[:-1]]))
    want = _reference(jlays, bases, np.concatenate(states), kmin, kmax, lo,
                      hi, quar)
    return dict(layouts=tuple(_port(j) for j in jlays), states=states,
                bases=bases, kmin=np.asarray(kmin, np.uint64),
                kmax=np.asarray(kmax, np.uint64), lo=lo, hi=hi, quar=quar,
                want=want)


def _flat(c) -> torch.Tensor:
    return _lanes(np.concatenate(c["states"]))


@pytest.mark.parametrize("cls", sorted(CLASSES))
def test_stacked_probe_matches_reference(cls):
    c = _case(cls)
    p = stacked_probe(c["layouts"], c["bases"], _CPU)
    flat, lo, hi = _flat(c), _t(c["lo"]), _t(c["hi"])
    w = c["want"]
    np.testing.assert_array_equal(p.range_all(flat, lo, hi).numpy(),
                                  w["range"])
    np.testing.assert_array_equal(p.point_all(flat, lo).numpy(), w["point"])
    fence, touch = p.touch_all(flat, _t(c["kmin"]), _t(c["kmax"]), lo, hi,
                               torch.from_numpy(c["quar"]))
    np.testing.assert_array_equal(fence.numpy(), w["fence"])
    np.testing.assert_array_equal(touch.numpy(), w["touch"])
    # quarantined rows answer "maybe" wherever their fence overlaps
    q = c["quar"]
    np.testing.assert_array_equal(touch.numpy()[:, q], w["fence"][:, q])


@pytest.mark.parametrize("cls", sorted(CLASSES))
@pytest.mark.parametrize("rpb", [0, 2])
def test_store_scan_probe_cpu_matches_reference(cls, rpb):
    c = _case(cls)
    stack = build_run_stack([_lanes(s) for s in c["states"]])
    rowpad = max(len(s) for s in c["states"])
    assert stack.shape == (len(c["states"]), rowpad)
    for r, s in enumerate(c["states"]):         # zero padding past each row
        assert not stack[r, len(s):].any()
    before = store_scan_probe.launches
    fence, touch = store_scan_probe(
        c["layouts"], stack, _t(c["kmin"]), _t(c["kmax"]), _t(c["lo"]),
        _t(c["hi"]), 64, rpb, torch.from_numpy(c["quar"]))
    assert store_scan_probe.launches == before    # the CPU path launches none
    np.testing.assert_array_equal(fence.numpy(), c["want"]["fence"])
    np.testing.assert_array_equal(touch.numpy(), c["want"]["touch"])
    f2, t2 = store_scan_probe_flat(
        c["layouts"], c["bases"], _flat(c), _t(c["kmin"]), _t(c["kmax"]),
        _t(c["lo"]), _t(c["hi"]), quarantine=torch.from_numpy(c["quar"]))
    assert torch.equal(f2, fence) and torch.equal(t2, touch)


def test_per_row_bounds_match_reference():
    c = _case("promoted")
    rng = np.random.default_rng(7)
    R = len(c["layouts"])
    lo = rng.integers(0, DMAX, (96, R), dtype=np.uint64)
    hi = np.minimum(lo + rng.integers(0, 1 << 22, (96, R), dtype=np.uint64),
                    DMAX)
    bases = c["bases"]
    jp = j_stacked(tuple(JLayout(**dataclasses.asdict(l)) for l in c["layouts"]),
                   bases)
    want = np.asarray(jp.range_all(jnp.asarray(np.concatenate(c["states"])),
                                   jnp.asarray(lo, jnp.uint32),
                                   jnp.asarray(hi, jnp.uint32)))
    p = stacked_probe(c["layouts"], bases, _CPU)
    np.testing.assert_array_equal(p.range_all(_flat(c), _t(lo), _t(hi)).numpy(),
                                  want)
    with pytest.raises(ValueError, match="bounds must be"):
        p.range_all(_flat(c), _t(lo[:, :1]), _t(hi[:, :1]))


class _GatherCount(torch.Tensor):
    """A flat state that counts the indexing reads made on it."""

    reads = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.__getitem__, torch.Tensor.index_select,
                    torch.index_select, torch.take, torch.Tensor.take,
                    torch.gather, torch.Tensor.gather) \
                and isinstance(args[0], cls):
            cls.reads += 1
        with torch._C.DisableTorchFunctionSubclass():   # results stay plain
            return func(*args, **(kwargs or {}))


def test_range_all_reads_the_flat_state_once():
    c = _case("mixed_delta")
    p = stacked_probe(c["layouts"], c["bases"], _CPU)
    flat = _flat(c).as_subclass(_GatherCount)
    lo, hi = _t(c["lo"]), _t(c["hi"])
    for fn, args in ((p.range_all, (lo, hi)), (p.point_all, (lo,)),
                     (p.touch_all, (_t(c["kmin"]), _t(c["kmax"]), lo, hi))):
        _GatherCount.reads = 0
        fn(flat, *args)
        assert _GatherCount.reads == 1, fn.__name__
    assert p.range_gather_width == sum(
        p.spans[i][0].range_gather_width * (p.spans[i][2] - p.spans[i][1])
        for i in range(len(p.spans)))


def test_stacked_kernels_cpu_and_filter_ops_dispatch():
    c = _case("capacity_ladder")
    lay, rows = c["layouts"][2], 4
    jl = JLayout(**dataclasses.asdict(lay))
    rng = np.random.default_rng(11)
    states = [_insert(jl, np.zeros(lay.total_u32, np.uint32),
                      rng.integers(0, DMAX, 1200, dtype=np.uint64))
              for _ in range(rows)]
    stack = _lanes(np.stack(states))
    lo, hi = c["lo"], c["hi"]
    want = _reference((jl,) * rows, tuple(r * lay.total_u32
                                          for r in range(rows)),
                      np.concatenate(states), np.zeros(rows), np.zeros(rows),
                      lo, hi, np.zeros(rows, bool))
    want_r, want_p = want["range"], want["point"]
    got_r = range_probe_stacked_resident(lay, stack, _t(lo), _t(hi))
    got_p = point_probe_stacked_resident(lay, stack, _t(lo))
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    # FilterOps: kernels within the budget, plain StackedProbe above it
    for budget in (None, lay.total_u32):
        ops = FilterOps(lay, vmem_budget_u32=budget)
        np.testing.assert_array_equal(
            ops.range_stacked(stack, _t(lo), _t(hi)).numpy(), want_r)
        np.testing.assert_array_equal(
            ops.point_stacked(stack, _t(lo)).numpy(), want_p)
    with pytest.raises(ValueError, match="stack must be"):
        range_probe_stacked_resident(lay, stack[:, :-1].contiguous(),
                                     _t(lo), _t(hi))
    with pytest.raises(ValueError, match="exact"):
        stacked_probe((_port(JLayout(
            d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
            seg_of_layer=(2, 2, 1, 1), seg_bits=(1 << 12, 4096, 8192),
            exact_seg=0)),), (0,), _CPU)
