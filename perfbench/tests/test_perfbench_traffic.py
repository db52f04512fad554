"""The generator: a seed gives the same inputs, every seed the same sizes,
and every distribution stays inside the key domain."""
from __future__ import annotations

import pytest
import torch

from perfbench import run, traffic

CONFIG = {"spec": {"dtype": "u32", "n": 1_000}, "keys": {"dist": "uniform"}}
MIX = {"ops": ["point", "range"], "batch": 900, "pool": 4,
       "point": {"present_share": 1 / 3}, "range": {"len_log2": 10}}


def _draw(seed):
    gen = run.generator(seed, "cpu")
    keys = traffic.make_keys(CONFIG, 1_000, gen, "cpu")
    return keys, traffic.make_pool(CONFIG, MIX, keys, gen, "cpu")


def test_a_seed_gives_the_same_inputs_and_sizes():
    (k1, p1), (k2, p2), (k3, p3) = _draw(2**40 + 1), _draw(2**40 + 1), \
        _draw(7)
    assert torch.equal(k1, k2) and not torch.equal(k1, k3)
    assert [(b.kind, b.size) for b in p1] == [(b.kind, b.size) for b in p3]
    assert [(b.kind, b.size) for b in p1] == [
        ("point", 900), ("range", 900), ("point", 900), ("range", 900)]
    for a, b in zip(p1, p2):
        for t in ("keys", "lo", "hi"):
            x, y = getattr(a, t), getattr(b, t)
            assert (x is None and y is None) or torch.equal(x, y)


def test_present_points_and_ranges_as_asked():
    keys, pool = _draw(3)
    pts, rng = pool[0].keys, pool[1]
    assert int(torch.isin(pts, keys).sum()) >= 300
    length = rng.hi - rng.lo + 1
    assert (length <= 1 << 10).all()
    assert int((length == 1 << 10).sum()) >= 899


@pytest.mark.parametrize("dtype,bits", [("u8", 8), ("u16", 16),
                                        ("u32", 32)])
def test_the_domain_is_the_dtype_s(dtype, bits):
    assert traffic.domain_bits({"spec": {"dtype": dtype}}) == bits


@pytest.mark.parametrize("dtype", ["u64", "f32", "str"])
def test_a_domain_the_generator_cannot_draw_is_refused(dtype):
    with pytest.raises(ValueError):
        traffic.domain_bits({"spec": {"dtype": dtype}})


@pytest.mark.parametrize("dist", [{"dist": "uniform"},
                                  {"dist": "normal", "mean": 0.5, "sd": 0.1},
                                  {"dist": "zipf", "s": 1.2}])
def test_every_distribution_stays_in_the_domain(dist):
    x = traffic.draw(dist, 10_000, 32, run.generator(5, "cpu"), "cpu")
    assert x.dtype == torch.int64 and x.numel() == 10_000
    assert int(x.min()) >= 0 and int(x.max()) < 1 << 32
    assert x.unique().numel() > 1_000
