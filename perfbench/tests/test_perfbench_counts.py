"""The roofline's work count depends on the keys' domain width, the
layout and the queries only, never on the integer type holding them."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import counts
from perfbench.reference import bloomrf as ref

MAX32 = (1 << 32) - 1


@pytest.fixture(scope="module")
def filt():
    rng = np.random.default_rng(11)
    keys = rng.integers(0, MAX32 + 1, 4_000)
    lay = ref.basic_layout(32, 4_000, 16)
    state = ref.build(lay, torch.from_numpy(keys))
    pts = np.concatenate([rng.choice(keys, 1_000),
                          rng.integers(0, MAX32 + 1, 1_000)])
    lo = rng.integers(0, MAX32 + 1, 2_000)
    hi = np.minimum(lo + np.floor(2.0 ** rng.uniform(0, 14, 2_000))
                    .astype(np.int64), MAX32)
    return lay, state, keys, pts, lo, hi


def _as(a: np.ndarray, dtype):
    """uint32 values held as int64, or their bits as int32."""
    if dtype == torch.int32:
        return torch.from_numpy(a.astype(np.uint32).view(np.int32))
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("op", ["point", "range", "insert"])
def test_count_is_the_same_for_int32_and_int64_keys(filt, op):
    lay, state, keys, pts, lo, hi = filt
    got = []
    for dt in (torch.int32, torch.int64):
        if op == "point":
            got.append(counts.point_bytes(lay, state, _as(pts, dt)))
        elif op == "range":
            got.append(counts.range_bytes(lay, state, _as(lo, dt),
                                          _as(hi, dt)))
        else:
            got.append(counts.insert_bytes(lay, _as(keys, dt)))
    assert got[0] == got[1] > 0


def test_point_count_by_hand(filt):
    """Keys at 4 bytes, a byte a verdict, and the distinct 32-byte sectors
    of each key's positions up to its first clear bit."""
    lay, state, _, pts, _, _ = filt
    lanes = state.numpy().view(np.uint32)
    sectors = set()
    for q in pts.tolist():
        for p in ref.positions(lay, torch.tensor([q]))[0].tolist():
            sectors.add(p >> 8)
            if not (int(lanes[p >> 5]) >> (p & 31)) & 1:
                break
    want = len(pts) * 5 + 32 * len(sectors)
    assert counts.point_bytes(lay, state, _as(pts, torch.int64)) == want


def test_insert_count_by_hand(filt):
    lay, _, keys, _, _, _ = filt
    pos = ref.positions(lay, _as(keys, torch.int64)).reshape(-1).tolist()
    want = len(keys) * 4 + 2 * 32 * len({p >> 8 for p in pos})
    assert counts.insert_bytes(lay, _as(keys, torch.int64)) == want


def test_range_count_is_bounded_by_the_plan(filt):
    """At least the bounds and verdicts; at most every word the plan can
    load (four a layer and query); swapped bounds count the same."""
    lay, state, _, _, lo, hi = filt
    L, H = _as(lo, torch.int64), _as(hi, torch.int64)
    got = counts.range_bytes(lay, state, L, H)
    assert got == counts.range_bytes(lay, state, H, L)
    fixed = len(lo) * 9
    assert fixed < got <= fixed + 32 * 4 * lay.k * len(lo)
