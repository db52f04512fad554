"""The benchmark's reference against ``repro_torch``'s plain path on the CPU:
layout, state and verdicts bit for bit, at small ``n``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import bloomrf as ref
from perfbench.reference import truth

MAX32 = (1 << 32) - 1

#: (spec n, bits per key, keys inserted): four, two and one layers
SHAPES = [(2_000, 16, 2_000), (300_000, 2, 20_000), (40_000_000, 0.05, 5_000)]


def _port(n, bpk, backend="xla"):
    from repro_torch import FilterSpec, open_filter

    return open_filter(FilterSpec(dtype="u32", n=n, bits_per_key=bpk,
                                  range_log2=14, backend=backend),
                       device="cpu")


def _queries(keys: np.ndarray, q: int, rng) -> tuple:
    """Present and absent points; ranges of log-uniform lengths, some at
    the domain's edges and some with swapped bounds."""
    pts = np.concatenate([rng.choice(keys, q // 2),
                          rng.integers(0, MAX32 + 1, q - q // 2)])
    lo = rng.integers(0, MAX32 + 1, q)
    ln = np.floor(2.0 ** rng.uniform(0, 14, q)).astype(np.int64)
    hi = np.minimum(lo + ln - 1, MAX32)
    lo[:4], hi[:4] = [0, MAX32, 0, 5], [MAX32, MAX32, 0, 3]
    near = rng.choice(keys, 64)
    lo[4:68], hi[4:68] = near - 3, near + 2
    return pts.astype(np.uint64), lo.astype(np.uint64), hi.astype(np.uint64)


def layout_fields(lay) -> dict:
    """What identifies a layout, read from either package's object."""
    seeds = [int(s) for i in range(lay.k)
             for s in (lay.seeds[i][:lay.replicas[i]])]
    return {"d": lay.d, "deltas": tuple(lay.deltas),
            "replicas": tuple(lay.replicas), "total_u32": lay.total_u32,
            "nwords": tuple(lay.nwords(i) for i in range(lay.k)),
            "seeds": tuple(seeds)}


@pytest.mark.parametrize("n,bpk,m", SHAPES)
def test_reference_equals_the_ports_plain_path(n, bpk, m):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, MAX32 + 1, m).astype(np.uint64)
    f = _port(n, bpk)
    lay = ref.basic_layout(32, n, bpk)
    assert layout_fields(lay) == layout_fields(f.layout)
    assert lay.k == {2_000: 4, 300_000: 2, 40_000_000: 1}[n]

    f.insert(keys)
    kt = torch.from_numpy(keys.view(np.int64))
    state = ref.build(lay, kt, block=1_000)
    assert torch.equal(state, f.state)

    pts, lo, hi = _queries(keys, 4_000, rng)
    as_t = lambda a: torch.from_numpy(a.view(np.int64))  # noqa: E731
    assert np.array_equal(ref.point_verdicts(lay, state, as_t(pts)).numpy(),
                          f.point(pts))
    assert np.array_equal(
        ref.range_verdicts(lay, state, as_t(lo), as_t(hi)).numpy(),
        f.range(lo, hi))


def test_reference_equals_filter_ops_on_both_tiers():
    """The window's entry, ``FilterOps``, on a CPU state takes the plain
    versions of the resident and partitioned wrappers."""
    from repro_torch.kernels.ops import FilterOps

    rng = np.random.default_rng(7)
    keys = rng.integers(0, MAX32 + 1, 3_000)
    lay = ref.basic_layout(32, 3_000, 16)
    kt = torch.from_numpy(keys)
    state = ref.build(lay, kt)
    pts, lo, hi = (torch.from_numpy(a.view(np.int64))
                   for a in _queries(keys.astype(np.uint64), 2_000, rng))
    f = _port(3_000, 16, backend="resident")
    for budget in (None, 0):
        ops = FilterOps(f.layout, vmem_budget_u32=budget)
        built = ops.insert(torch.zeros_like(state), kt)
        assert torch.equal(built, state)
        assert torch.equal(ops.point(built, pts),
                           ref.point_verdicts(lay, state, pts))
        assert torch.equal(ops.range(built, lo, hi),
                           ref.range_verdicts(lay, state, lo, hi))


def test_no_false_negatives_against_the_truth():
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, MAX32 + 1, 5_000))
    lay = ref.basic_layout(32, 5_000, 16)
    state = ref.build(lay, keys)
    pts, lo, hi = (torch.from_numpy(a.view(np.int64)) for a in
                   _queries(keys.numpy().astype(np.uint64), 6_000, rng))
    sk = truth.sort_keys(keys)
    pt, rt = truth.point_truth(sk, pts), truth.range_truth(sk, lo, hi)
    assert pt[:3_000].all() and rt[4:68].all()
    assert not (pt & ~ref.point_verdicts(lay, state, pts)).any()
    assert not (rt & ~ref.range_verdicts(lay, state, lo, hi)).any()
    # brute force on a slice
    for q in range(0, 6_000, 97):
        a, b = sorted((int(lo[q]), int(hi[q])))
        assert bool(rt[q]) == bool(((keys >= a) & (keys <= b)).any())


def test_range_read_hook_changes_no_verdict():
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(rng.integers(0, MAX32 + 1, 2_000))
    lay = ref.basic_layout(32, 2_000, 16)
    state = ref.build(lay, keys)
    _, lo, hi = (torch.from_numpy(a.view(np.int64)) for a in
                 _queries(keys.numpy().astype(np.uint64), 3_000, rng))
    seen = []
    with_hook = ref.range_verdicts(lay, state, lo, hi,
                                   on_read=lambda i, w, m: seen.append(m))
    assert torch.equal(with_hook, ref.range_verdicts(lay, state, lo, hi))
    assert seen and all(m.shape == lo.shape for m in seen)
