"""The host side of the kernels' descriptors
(``repro_torch/kernels/_build.py``): each layer's exact reciprocal of its
word count, emulated in numpy exactly as ``csrc/rangeplan.cuh::fast_mod``
computes it on the card, against ``h % n``; the stack descriptor's row
table; and the descriptor launch parameter and its capacity.  No card, no
nvcc, no JAX."""
import numpy as np
import pytest
import torch

from repro_torch.core import FilterLayout, basic_layout
from repro_torch.kernels import _build

_LANE = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _fast_mod(h: np.ndarray, magic: int, n: int) -> np.ndarray:
    """fast_mod's arithmetic on uint64 lanes: the high 64 bits of
    ``((M * h) mod 2^64) * n``, from two 32 x 32 -> 64-bit products."""
    low = np.uint64(magic) * h.astype(np.uint64)      # wraps mod 2^64
    t = (low & _LANE) * np.uint64(n)
    u = (low >> _S32) * np.uint64(n) + (t >> _S32)
    return (u >> _S32).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 2, 3, (1 << 31) - 1, (1 << 31) + 1,
                               (1 << 32) - 1])
def test_fastmod_magic_is_exact(n):
    rng = np.random.default_rng(n % 1000)
    h = np.concatenate([rng.integers(0, 1 << 32, 100_000, dtype=np.uint64),
                        np.asarray([0, 1, n - 1, n, n + 1, (1 << 31) - 1,
                                    1 << 31, (1 << 32) - 1],
                                   np.uint64) & _LANE])
    got = _fast_mod(h, _build.fastmod_magic(n), n)
    np.testing.assert_array_equal(got, (h % np.uint64(n)).astype(np.uint32))


def test_fastmod_magic_rejects_word_counts_outside_32_bits():
    for n in (0, 1 << 32):
        with pytest.raises(ValueError, match="word count"):
            _build.fastmod_magic(n)


_LAYOUTS = {
    "phase3": basic_layout(32, 2_000_000, 16.0, delta=7),
    "store_class": basic_layout(32, 8192, 14.0, delta=6),
    "multiseg_replicas": FilterLayout(d=32, deltas=(6, 5, 4),
                                      replicas=(2, 1, 2),
                                      seg_of_layer=(0, 1, 0),
                                      seg_bits=(8192, 4096)),
}


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_layout_descriptor_carries_each_layers_reciprocal(name):
    lay = _LAYOUTS[name]
    desc = _build.layout_descriptor(lay).astype(np.int64)
    assert desc[5] == len(desc)                     # H_LEN: every word
    seeds_end = 8 + 8 * lay.k + sum(lay.replicas)
    assert len(desc) == seeds_end + 2 * lay.k
    for i in range(lay.k):
        off = desc[8 + 8 * i + 7]                   # L_FASTMOD_OFF
        assert off == seeds_end + 2 * i
        magic = int(desc[off]) | int(desc[off + 1]) << 32
        assert magic == _build.fastmod_magic(lay.nwords(i))
        h = np.random.default_rng(i).integers(0, 1 << 32, 10_000,
                                              dtype=np.uint64)
        np.testing.assert_array_equal(
            _fast_mod(h, magic, lay.nwords(i)),
            (h % np.uint64(lay.nwords(i))).astype(np.uint32))


def test_stack_descriptor_row_table():
    """Each distinct layout's descriptor once, and per row the offset of its
    layout's descriptor and its base lane: the store-scan kernel stages the
    whole descriptor and reads each row through this table."""
    a, b, c = (_LAYOUTS["store_class"], basic_layout(32, 32768, 14.0, delta=6),
               _LAYOUTS["multiseg_replicas"])
    layouts = (a, b, a, c, b, a)
    sizes = [lay.total_u32 for lay in layouts]
    bases = tuple(int(x) for x in np.cumsum([0] + sizes[:-1]))
    desc, rowtab = _build.stack_descriptor(layouts, bases,
                                           torch.device("cpu"))
    words = desc.numpy().view(np.uint32)
    assert len(words) == sum(len(_build.layout_descriptor(lay))
                             for lay in (a, b, c))
    assert rowtab.dtype == torch.int64 and rowtab.shape == (len(layouts), 2)
    for r, lay in enumerate(layouts):
        off, base = (int(v) for v in rowtab[r])
        one = _build.layout_descriptor(lay)
        np.testing.assert_array_equal(words[off:off + len(one)], one)
        assert base == bases[r]
    assert len({int(v) for v in rowtab[:, 0]}) == 3


@pytest.mark.parametrize("name", list(_LAYOUTS))
def test_insert_descriptor_is_the_layout_descriptor_padded(name):
    """The descriptor launch parameter (insert, point probe and stacked
    range kernels): the layout descriptor word for word, zero-padded to the
    parameter's fixed capacity."""
    lay = _LAYOUTS[name]
    desc = _build.layout_descriptor(lay)
    param = _build.param_descriptor(lay)
    assert param.dtype == np.uint32
    assert param.shape == (_build.PARAM_DESC_WORDS,)
    np.testing.assert_array_equal(param[:len(desc)], desc)
    assert not param[len(desc):].any()
    assert param[5] == len(desc)                    # H_LEN, the kernel checks
    assert _build.param_descriptor(lay) is param    # packed once per layout


def test_insert_descriptor_refuses_what_exceeds_its_capacity():
    """31 layers of 8 replicas need 566 words; the widest basic layout
    (d = 32, Δ = 1) needs 349."""
    wide = FilterLayout(d=32, deltas=(1,) * 31, replicas=(8,) * 31,
                        seg_of_layer=(0,) * 31, seg_bits=(1 << 16,))
    assert len(_build.layout_descriptor(wide)) > _build.PARAM_DESC_WORDS
    with pytest.raises(ValueError, match="descriptor parameter"):
        _build.param_descriptor(wide)
    widest_basic = basic_layout(32, 3000, 16.0, delta=1)
    assert len(_build.param_descriptor(widest_basic)) == \
        _build.PARAM_DESC_WORDS


def test_param_capacity_matches_the_kernels():
    """The host packer pads to the capacity the CUDA parameter struct holds
    (``csrc/bloomrf.cuh``: ``kParamDescWords``), read from the source."""
    import re

    src = (_build.CSRC / "bloomrf.cuh").read_text()
    m = re.search(r"constexpr int kParamDescWords = (\d+);", src)
    assert m and int(m.group(1)) == _build.PARAM_DESC_WORDS
