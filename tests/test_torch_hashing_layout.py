"""The port's hashing, layout, model, tuning and codec modules against
``repro``'s: same inputs, made with numpy, and exact equality."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.codecs as jcodecs
import repro.core.hashing as jhash
import repro.core.model as jmodel
import repro.core.tuning as jtuning
import repro_torch.core.codecs as tcodecs
import repro_torch.core.hashing as thash
import repro_torch.core.model as tmodel
import repro_torch.core.tuning as ttuning
from repro.core import FilterLayout as JLayout
from repro.core import basic_layout as jbasic
from repro_torch.core import FilterLayout as TLayout
from repro_torch.core import basic_layout as tbasic


def _i64(a):
    return torch.from_numpy(np.asarray(a, np.uint64).astype(np.int64))


def test_mix32_matches_reference():
    x = np.random.default_rng(0x3132).integers(0, 1 << 32, 100_000,
                                               dtype=np.uint64)
    want = np.asarray(jhash.mix32(jnp.asarray(x, jnp.uint32)))
    got = thash.mix32(_i64(x)).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


@pytest.mark.parametrize("seed", [0, 0x0B100F11, (1 << 64) - 1, 12345])
def test_seeded_mix_and_seeds_match(seed):
    np.testing.assert_array_equal(jhash.derive_seeds(seed, 9),
                                  thash.derive_seeds(seed, 9))
    x = np.random.default_rng(seed & 0xFFFF).integers(0, 1 << 32, 4096,
                                                      dtype=np.uint64)
    want = np.asarray(jhash.mix(jnp.asarray(x, jnp.uint32), np.uint64(seed), 32))
    got = thash.mix(_i64(x), np.uint64(seed), 32).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


def test_dyadic_prefixes_match():
    x = np.random.default_rng(7).integers(0, 1 << 24, 1000, dtype=np.uint64)
    want = np.asarray(jhash.dyadic_prefixes(jnp.asarray(x, jnp.uint32), 5, 24))
    got = thash.dyadic_prefixes(_i64(x), 5, 24).numpy()
    np.testing.assert_array_equal(want.astype(np.int64), got)


def test_64bit_domains_not_ported():
    """Domains wider than 64 bits are refused, as in the reference; 64-bit
    domains are ported (they raised ``NotImplementedError`` naming ROADMAP
    A.1 before): int64 carriers, ``mix`` taking ``mix64`` above 32 bits."""
    assert thash.key_dtype_for(64) == torch.int64
    with pytest.raises(ValueError, match="<= 64"):
        thash.key_dtype_for(65)
    x = _i64([1, 7])
    torch.testing.assert_close(thash.mix(x, 3, 64), thash.mix64(x ^ 3))


_LAYOUTS = (
    [jbasic(24, 800, 14.0, delta=dl) for dl in range(1, 8)]
    + [jbasic(32, 2, 16.0), jbasic(8, 12, 14.0, delta=3),
       JLayout(d=32, deltas=(7, 7), replicas=(1, 2), seg_of_layer=(0, 0),
               seg_bits=(16384,)),
       JLayout(d=32, deltas=(6, 5, 4), replicas=(2, 1, 2),
               seg_of_layer=(0, 1, 0), seg_bits=(8192, 4096)),
       JLayout(d=32, deltas=(7, 7, 4, 2), replicas=(1, 1, 1, 2),
               seg_of_layer=(2, 2, 1, 1), seg_bits=(1 << 12, 4096, 8192),
               exact_seg=0, seed=99),
       jtuning.advise(32, 5000, 80_000, R=2.0 ** 20).layout,
       jtuning.advise(16, 800, 12_800, R=2.0 ** 8).layout])


@pytest.mark.parametrize("jl", _LAYOUTS, ids=lambda lay: f"{lay.deltas}")
def test_layout_tables_match(jl):
    tl = TLayout.from_dict(dataclasses.asdict(jl))
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    np.testing.assert_array_equal(tl.seeds, jl.seeds)
    assert tl.seg_alloc_bits == jl.seg_alloc_bits
    assert tl.seg_off_bits == jl.seg_off_bits
    assert tl.total_u32 == jl.total_u32
    assert tl.levels == jl.levels and tl.top_level == jl.top_level
    assert [tl.nwords(i) for i in range(tl.k)] == \
        [jl.nwords(i) for i in range(jl.k)]
    assert tl.describe() == jl.describe()


def test_layout_from_dict_accepts_json_lists_and_rejects_unknown():
    jl = _LAYOUTS[-3]
    d = {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(jl).items()}
    assert TLayout.from_dict(d) == TLayout.from_dict(dataclasses.asdict(jl))
    with pytest.raises(ValueError, match="unknown"):
        TLayout.from_dict({**d, "bogus": 1})


@pytest.mark.parametrize("d,n,delta", [(8, 10, 3), (24, 3000, 4),
                                       (32, 2_000_000, 7)])
def test_basic_layout_and_model_match(d, n, delta):
    jl = jbasic(d, n, 16.0, delta=delta)
    tl = TLayout.from_dict(dataclasses.asdict(jl))
    assert dataclasses.asdict(tbasic(d, n, 16.0, delta=delta)) == \
        dataclasses.asdict(jl)
    assert tmodel.basic_range_fpr(d, n, 16 * n, 2.0 ** 10, delta=delta) == \
        jmodel.basic_range_fpr(d, n, 16 * n, 2.0 ** 10, delta=delta)
    np.testing.assert_array_equal(tmodel.level_fprs(tl, n).fpr,
                                  jmodel.level_fprs(jl, n).fpr)


@pytest.mark.parametrize("d,n,R", [(32, 5000, 2.0 ** 20), (16, 800, 2.0 ** 8),
                                   (32, 100_000, 2.0 ** 24)])
def test_advise_matches(d, n, R):
    j = jtuning.advise(d, n, 16 * n, R=R)
    t = ttuning.advise(d, n, 16 * n, R=R)
    assert dataclasses.asdict(t.layout) == dataclasses.asdict(j.layout)
    assert (t.fpr_point, t.fpr_range_max, t.exact_level) == \
        (j.fpr_point, j.fpr_range_max, j.exact_level)


def test_float_codecs_match():
    x = np.random.default_rng(11).normal(0, 1e3, 5000).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    np.testing.assert_array_equal(tcodecs.float32_to_u32(x),
                                  jcodecs.float32_to_u32(x))
    c = jcodecs.float32_to_u32(x)
    np.testing.assert_array_equal(tcodecs.u32_to_float32(c),
                                  jcodecs.u32_to_float32(c))
