"""A plain bloomRF over uint32 keys: the basic layout, its hashing, a
build, and point and range probes, in plain PyTorch.

This is the benchmark's frozen reference.  It follows the paper (§3–§5:
prefix hashing, piecewise-monotone hash functions of ``2^(Δ-1)``-bit words,
the two-path dyadic range decomposition of Algorithm 1) in the form the
bloomRF reproduction fixed: splitmix64 seed derivation, a murmur3-style
32-bit finalizer, one shared segment of ``n * bits_per_key`` bits, and a
conservative "maybe" for a range whose middle spans a whole top-level
interval (the basic layout omits the saturated top levels).  The same keys
and layout therefore give the same state bits and verdicts as any correct
bloomRF of that layout.

It covers what the benchmark's configurations run: ``d <= 32`` and the
tuning-free basic layout (hashed layers only, one segment).  A
configuration names its reference module under ``reference`` (this one is
``"bloomrf"``); a layout this one does not cover comes as a new module
with the same functions.  Keys, bounds
and every intermediate are int64 tensors holding uint32 values; the state
is ``int32[total_u32]`` lanes holding the uint32 bits.  It computes on the
device of its inputs and imports nothing but torch.

``range_verdicts`` takes an optional ``on_read(layer, wordkey, need)``
hook, called at every word the plan loads with the mask of queries whose
verdict still needs that word; ``perfbench/counts.py`` counts the work
from it.  The hook changes no verdict.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["Layout", "layout", "basic_layout", "positions", "build",
           "point_verdicts", "range_verdicts", "MASK32"]

MASK32 = 0xFFFFFFFF
_DEFAULT_SEED = 0x0B100F11
_M64 = (1 << 64) - 1


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def derive_seeds(base: int, n: int) -> tuple:
    """``n`` splitmix64 outputs from ``base`` (python ints)."""
    out, s = [], base & _M64
    for _ in range(n):
        s = (s + 0x9E3779B97F4A7C15) & _M64
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        out.append(z ^ (z >> 31))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A hashed bloomRF layout in one segment: layer ``i`` covers levels
    ``[levels[i], levels[i + 1])`` with words of ``2^(Δ_i - 1)`` bits."""

    d: int
    deltas: tuple           # bottom-first Δ_i
    replicas: tuple         # hash functions per layer
    seg_bits: int           # the one segment's requested bits
    seed: int

    @property
    def k(self) -> int:
        return len(self.deltas)

    @property
    def levels(self) -> tuple:
        lv = [0]
        for dl in self.deltas:
            lv.append(lv[-1] + dl)
        return tuple(lv)

    def word_bits(self, i: int) -> int:
        return 1 << (self.deltas[i] - 1)

    @property
    def total_bits(self) -> int:
        align = 64 if any(self.word_bits(i) == 64 for i in range(self.k)) \
            else 32
        return _round_up(max(self.seg_bits, align), align)

    @property
    def total_u32(self) -> int:
        return self.total_bits // 32

    def nwords(self, i: int) -> int:
        return self.total_bits // self.word_bits(i)

    @property
    def seeds(self) -> tuple:
        """Per layer, its replicas' 64-bit seeds."""
        rmax = max(self.replicas)
        flat = derive_seeds(self.seed, self.k * rmax)
        return tuple(flat[i * rmax:i * rmax + self.replicas[i]]
                     for i in range(self.k))


def basic_layout(d: int, n: int, bits_per_key: float, delta: int = 7,
                 seed: int = _DEFAULT_SEED) -> Layout:
    """The paper's tuning-free layout: ``k = ceil((d - log2 n) / Δ)``
    equidistant layers (saturated top levels omitted, top distances cut to
    fit ``d``), one hash function each, ``n * bits_per_key`` bits."""
    if not 1 <= d <= 32:
        raise ValueError(f"the reference covers d <= 32, got d={d}")
    log2n = math.log2(max(n, 2))
    k = max(1, math.ceil((d - log2n) / delta))
    k = min(k, max(1, math.ceil(d / delta)))
    deltas = [delta] * k
    while sum(deltas) > d:
        if deltas[-1] > 1:
            deltas[-1] -= 1
        else:
            deltas.pop()
    min_bits = 2 * (1 << (max(deltas) - 1))
    m = _round_up(max(int(n * bits_per_key), min_bits, 64), 64)
    return Layout(d=d, deltas=tuple(deltas), replicas=(1,) * len(deltas),
                  seg_bits=m, seed=seed)


def layout(config: dict, bits: int) -> Layout:
    """The layout a configuration's spec selects, for a ``bits``-bit key
    domain: the basic layout, which ``tuning`` "basic", or "auto" up to
    ``range_log2`` 14, selects.  A configuration that selects another
    layout names another reference module."""
    spec = config["spec"]
    tuning = spec.get("tuning", "auto")
    if tuning not in ("auto", "basic") or (
            tuning == "auto" and spec.get("range_log2", 14) > 14):
        raise ValueError("this reference covers the basic layout only")
    return basic_layout(bits, spec["n"], spec["bits_per_key"],
                        delta=spec.get("delta") or min(7, bits),
                        seed=spec.get("seed", _DEFAULT_SEED))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` in int64 without overflow (16-bit halves of c)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """The seeded 32-bit finalizer: murmur3's fmix of ``x ^ seed``."""
    x = (x & MASK32) ^ (seed & MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def word_bit(lay: Layout, i: int, rep: int, wordkey: torch.Tensor):
    """First bit of the layer-``i`` word that ``wordkey`` hashes to."""
    h = mix32(wordkey, lay.seeds[i][rep])
    return (h % lay.nwords(i)) * lay.word_bits(i)


def positions(lay: Layout, keys: torch.Tensor) -> torch.Tensor:
    """``(B, P)`` bit positions of each key, bottom layer first: per layer
    and replica, the key's bit in the word of its prefix."""
    x = keys.to(torch.int64) & MASK32
    out = []
    for i in range(lay.k):
        li, W = lay.levels[i], lay.word_bits(i)
        wkey = x >> (li + lay.deltas[i] - 1)
        for rep in range(lay.replicas[i]):
            out.append(word_bit(lay, i, rep, wkey) + ((x >> li) & (W - 1)))
    return torch.stack(out, dim=1)


def _bits_set(state: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    lane = state[pos >> 5].to(torch.int64) & MASK32
    return ((lane >> (pos & 31)) & 1) == 1


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def build(lay: Layout, keys: torch.Tensor, block: int = 1 << 22):
    """The state of ``keys``: a bitmap with every position set, packed into
    ``int32`` lanes (bit ``b`` of lane ``j`` is bit ``32 j + b``), built on
    the keys' device ``block`` keys and lanes at a time."""
    dev = keys.device
    bits = torch.zeros(lay.total_bits, dtype=torch.bool, device=dev)
    for s in range(0, keys.numel(), block):
        bits[positions(lay, keys[s:s + block]).reshape(-1)] = True
    weights = torch.ones(32, dtype=torch.int64, device=dev) \
        << torch.arange(32, device=dev)
    state = torch.empty(lay.total_u32, dtype=torch.int32, device=dev)
    for s in range(0, lay.total_u32, block):
        lanes = bits[32 * s:32 * (s + block)].view(-1, 32).to(torch.int64)
        packed = (lanes * weights).sum(dim=1)
        state[s:s + block] = torch.where(packed >= 1 << 31,
                                         packed - (1 << 32),
                                         packed).to(torch.int32)
    return state


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def point_verdicts(lay: Layout, state: torch.Tensor,
                   keys: torch.Tensor) -> torch.Tensor:
    """A key is "maybe" iff every one of its position bits is set."""
    return _bits_set(state, positions(lay, keys)).all(dim=1)


def _mask(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 mask with bits ``[a..b]`` set (clamped to 0..31; empty if
    ``b < a``)."""
    a_c = torch.clamp(a, 0, 32)
    width = torch.clamp(torch.clamp(b + 1, 0, 32) - a_c, min=0)
    base = torch.where(width >= 32, MASK32,
                       (torch.ones_like(width) << torch.clamp(width, max=31))
                       - 1)
    return torch.where(width > 0, (base << torch.clamp(a_c, max=31)) & MASK32,
                       0)


def _mask_pair(a, b, W: int):
    """(low, high) lane masks of bits ``[a..b]`` of a ``W``-bit word."""
    if W <= 32:
        m = _mask(a, b)
        return m, torch.zeros_like(m)
    return _mask(a, torch.clamp(b, max=31)), _mask(a - 32, b - 32)


def _load_word(lay: Layout, state: torch.Tensor, i: int,
               wordkey: torch.Tensor):
    """The layer-``i`` word of ``wordkey`` as (low, high) uint32 halves,
    ANDed over the layer's replicas."""
    W = lay.word_bits(i)
    lo = torch.full_like(wordkey, MASK32)
    hi = torch.full_like(wordkey, MASK32 if W == 64 else 0)
    for rep in range(lay.replicas[i]):
        bit = word_bit(lay, i, rep, wordkey)
        v = state[bit >> 5].to(torch.int64) & MASK32
        if W == 64:
            lo = lo & v
            hi = hi & (state[(bit >> 5) + 1].to(torch.int64) & MASK32)
        elif W == 32:
            lo = lo & v
        else:
            lo = lo & ((v >> (bit & 31)) & ((1 << W) - 1))
    return lo, hi


def _covered(lay: Layout, state, i: int, x: torch.Tensor) -> torch.Tensor:
    """The covering bit of ``x``'s prefix at layer ``i``."""
    li, W = lay.levels[i], lay.word_bits(i)
    off = (x >> li) & (W - 1)
    lo, hi = _load_word(lay, state, i, x >> (li + lay.deltas[i] - 1))
    bit = (lo >> torch.clamp(off, max=31)) & 1
    if W == 64:
        bit = torch.where(off < 32, bit,
                          (hi >> (torch.clamp(off, min=32) - 32)) & 1)
    return bit != 0


def _children(lay: Layout, state, i: int, parent, qlo, qhi, live, on_read):
    """Any child prefix of ``parent`` in ``[qlo, qhi]`` set at layer ``i``:
    the parent's ``2W`` children fill its two words."""
    delta, W = lay.deltas[i], lay.word_bits(i)
    base = parent << delta
    last = base | ((1 << delta) - 1)
    o_lo = torch.minimum(torch.maximum(qlo, base), last) - base
    o_hi = torch.minimum(torch.maximum(qhi, base), last) - base
    if on_read is not None:
        on_read(i, parent << 1, live & (o_lo <= W - 1))
        on_read(i, (parent << 1) | 1, live & (o_hi >= W))
    wa = _load_word(lay, state, i, parent << 1)
    wb = _load_word(lay, state, i, (parent << 1) | 1)
    m_lo, m_hi = _mask_pair(o_lo, torch.clamp(o_hi, max=W - 1), W)
    acc = (wa[0] & m_lo) | (wa[1] & m_hi)
    m_lo, m_hi = _mask_pair(torch.clamp(o_lo - W, min=0), o_hi - W, W)
    acc = acc | (wb[0] & m_lo) | (wb[1] & m_hi)
    return live & (acc != 0)


def range_verdicts(lay: Layout, state: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, on_read=None) -> torch.Tensor:
    """Algorithm 1: walk the left and right paths of ``[lo, hi]`` (bounds in
    either order) from the top layer down.  Each path tests the child
    prefixes of its parent that fall inside the range and continues only
    while the covering bit of its bound's prefix is set."""
    lo = lo.to(torch.int64) & MASK32
    hi = hi.to(torch.int64) & MASK32
    L, R = torch.minimum(lo, hi), torch.maximum(lo, hi)
    top = lay.levels[lay.k]
    true = torch.ones_like(L, dtype=torch.bool)
    if top >= lay.d:
        result, split = ~true, ~true
        left_alive, right_alive = true, ~true
    else:
        lt, rt = L >> top, R >> top
        split = lt != rt
        # a middle of whole top-level intervals is untestable: "maybe"
        result = (rt - lt) >= 2
        left_alive, right_alive = true, split

    for i in reversed(range(lay.k)):
        li, delta = lay.levels[i], lay.deltas[i]
        bottom = i == 0
        edge = 0 if bottom else 1
        Lp, Rp = L >> li, R >> li
        Lpar, Rpar = L >> lay.levels[i + 1], R >> lay.levels[i + 1]

        l_end = (Lpar << delta) | ((1 << delta) - 1)
        l_qlo = (Lp + edge) & MASK32
        l_qhi = torch.where(split, l_end, (Rp - edge) & MASK32)
        l_nonempty = true if bottom else torch.where(split, Lp != l_end,
                                                     (Rp - Lp) >= 2)
        result = result | _children(lay, state, i, Lpar, l_qlo, l_qhi,
                                    l_nonempty & left_alive & ~result,
                                    on_read)

        r_start = Rpar << delta
        r_nonempty = true if bottom else Rp != r_start
        result = result | _children(lay, state, i, Rpar, r_start,
                                    (Rp - edge) & MASK32,
                                    r_nonempty & right_alive & ~result,
                                    on_read)

        if not bottom:
            new_split = split | (Lp != Rp)
            need_l = left_alive & ~result
            need_r = torch.where(split, right_alive,
                                 left_alive & new_split) & ~result
            if on_read is not None:
                on_read(i, L >> (li + delta - 1), need_l)
                on_read(i, R >> (li + delta - 1), need_r)
            left_alive = need_l & _covered(lay, state, i, L)
            right_alive = need_r & _covered(lay, state, i, R)
            split = new_split
    return result
