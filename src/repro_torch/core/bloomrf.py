"""bloomRF: point-range filter with prefix hashing and piecewise-monotone
hash functions (PMHF), in plain PyTorch.

Counterpart of ``repro/core/bloomrf.py``.

* The filter state is a flat ``int32[total_u32]`` tensor ("lanes") holding
  the reference's uint32 bits unchanged.  A PMHF *word* of ``W = 2^{Δ-1}``
  bits is 1–2 lanes; words never straddle lanes.
* Keys, bounds and every intermediate travel as ``int64`` tensors: the
  uint32 value for ``d <= 32``, where the reference's uint32 add or
  subtract can wrap the result is masked back to 32 bits (``_wrap``); the
  uint64 bits for ``d > 32``, where int64 arithmetic wraps as uint64 does
  and compares, right shifts and the word-index modulo go through
  ``core/uint64.py``.  Lanes read from the state are widened one gather at
  a time with ``.to(torch.int64) & 0xFFFFFFFF``; the whole state is never
  widened.
* Everything is batched natively on ``(B,)`` vectors: the reference's
  ``vmap`` over a scalar function becomes a batch dimension written out.
* ``point``/``range`` route through the plan->gather->combine engine
  (``core/engine.py``); ``point_reference``/``range_reference`` are the
  scalar-path oracles the engine and the CUDA kernels are held to.

False-negative freedom: insert and every probe share the single pair of
position functions ``_load_word`` / ``_bit_probe``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import uint64 as u64
from .hashing import MASK32, key_dtype_for, mix
from .layout import FilterLayout

__all__ = ["BloomRF"]

_FULL = MASK32


def resolve_device(device) -> torch.device:
    """``device`` as given, or ``"cuda"`` when it is None; raises when a
    CUDA device is asked for, by default or by name, and no card is present
    (nothing in the port quietly picks the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain path on the CPU")
    return dev


def lanes_u32(state: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """Gather ``state[lane]`` and widen the uint32 bits to int64."""
    return state[lane].to(torch.int64) & MASK32


def as_lanes(v: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 lanes with the same bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def _mask_u32(a, b):
    """uint32 mask with bits [a..b] set; empty when b < a (clamped)."""
    a = torch.as_tensor(a, dtype=torch.int64)
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    a_c = torch.clamp(a, 0, 32)
    b_c = torch.clamp(b + 1, 0, 32)
    width = torch.clamp(b_c - a_c, min=0)
    sh_w = torch.clamp(width, max=31)
    base = torch.where(width >= 32, _FULL, (torch.ones_like(sh_w) << sh_w) - 1)
    sh_a = torch.clamp(a_c, max=31)
    return torch.where(width > 0, (base << sh_a) & MASK32, 0)


def _mask_pair(a, b, W: int):
    """(lo, hi) uint32 masks for bit range [a..b] in a W-bit word."""
    if W <= 32:
        lo = _mask_u32(a, b)
        return lo, torch.zeros_like(lo)
    return (_mask_u32(a, torch.clamp(torch.as_tensor(b), max=31)),
            _mask_u32(a - 32, b - 32))


def children_hit(delta: int, parent, qlo, qhi, nonempty, wa, wb):
    """Any child prefix in ``[qlo, qhi]`` of ``parent`` set in the two child
    words ``wa``/``wb`` (each a (lo, hi) pair)?  The clip and mask algebra of
    the reference's ``_children_any``, shared by the scalar path and the
    engine's combine."""
    W = 1 << (delta - 1)
    base = parent << delta
    last = base | ((1 << delta) - 1)
    qlo_c = u64.clamp(qlo, base, last)
    qhi_c = u64.clamp(qhi, base, last)
    o_lo = qlo_c - base                                # 0..2W-1
    o_hi = qhi_c - base
    mAlo, mAhi = _mask_pair(o_lo, torch.clamp(o_hi, max=W - 1), W)
    acc = (wa[0] & mAlo) | (wa[1] & mAhi)
    # empty automatically when o_hi < W (negative b -> zero mask)
    mBlo, mBhi = _mask_pair(torch.clamp(o_lo - W, min=0), o_hi - W, W)
    acc = acc | (wb[0] & mBlo) | (wb[1] & mBhi)
    return nonempty & (acc != 0)


class BloomRF:
    """Unified point-range filter (paper §3–§7) on torch tensors.

    Stateless apart from its layout: every method takes and returns the
    filter state, as the reference does.  ``device`` (default ``"cuda"``) is
    where :meth:`init_state` allocates; probes run wherever their inputs
    lie."""

    def __init__(self, layout: FilterLayout, device=None):
        self.layout = layout
        self.kdtype = key_dtype_for(layout.d)
        #: keys are uint64 bits (d > 32) rather than uint32 values
        self.wide = layout.d > 32
        if layout.total_bits >= 1 << 31:
            raise ValueError(
                f"bit positions are int32 for d <= 32 domains, and word "
                f"indices stay below 2^31; a filter of {layout.total_bits} "
                f"bits does not fit")
        self.device = resolve_device(device)
        self._seeds = layout.seeds  # np.uint64 (k, rmax)
        self._engine = None

    @property
    def engine(self):
        """The plan->gather->combine probe engine (core/engine.py), lazily
        built; ``point``/``range`` route through it."""
        if self._engine is None:
            from .engine import ProbeEngine

            self._engine = ProbeEngine(self)
        return self._engine

    # -- helpers ---------------------------------------------------------
    def _keys(self, v) -> torch.Tensor:
        """Key codes as a 1-d int64 carrier."""
        return self._wrap(torch.atleast_1d(torch.as_tensor(v,
                                                           dtype=self.kdtype)))

    def _wrap(self, v):
        """A key-domain value after an add or subtract, as the reference's
        uint32 (d <= 32) or uint64 arithmetic leaves it."""
        return v if self.wide else v & MASK32

    def _shr(self, x, s: int):
        """x >> s with the static s == d case (full shift-out) well-defined;
        a logical shift of the uint64 bits for d > 32."""
        if self.wide:
            return u64.shr(x, s)
        if s >= self.layout.d and s >= 32:
            return torch.zeros_like(x)
        return x >> s

    def init_state(self) -> torch.Tensor:
        return torch.zeros(self.layout.total_u32, dtype=torch.int32,
                           device=self.device)

    def _word_bitoff(self, i: int, rep: int, wordkey):
        """Bit offset of the layer-i word addressed by ``wordkey`` for one
        replica: the segment offset plus the hashed word index times W."""
        lay = self.layout
        nw = lay.nwords(i)
        offbits = lay.seg_off_bits[lay.seg_of_layer[i]]
        h = mix(wordkey, self._seeds[i, rep], lay.d)
        widx = u64.mod(h, nw) if self.wide else h % nw
        return (offbits + widx * lay.word_bits(i)) & MASK32

    # ------------------------------------------------------------------
    # position computation (shared by insert and probes)
    # ------------------------------------------------------------------
    def positions(self, keys) -> torch.Tensor:
        """``(B, P)`` bit positions set/probed for each key: one per hashed
        replica of every layer, plus the exact-bitmap bit."""
        lay = self.layout
        x = self._keys(keys)
        out = []
        for i in range(lay.k):
            li = lay.levels[i]
            W = lay.word_bits(i)
            off = self._shr(x, li) & (W - 1)
            wkey = self._shr(x, li + lay.deltas[i] - 1)
            for rep in range(lay.replicas[i]):
                out.append((self._word_bitoff(i, rep, wkey) + off) & MASK32)
        if lay.has_exact:
            out.append(self._wrap(lay.exact_off_bits
                                  + self._shr(x, lay.top_level)))
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------
    def scatter_or(self, state: torch.Tensor, pos: torch.Tensor,
                   vals: Optional[torch.Tensor] = None,
                   bitmap: bool = False) -> torch.Tensor:
        """OR bit positions into the packed state; returns a new state.
        ``vals`` (optional, same shape as ``pos``) masks which positions take
        effect.

        Default path: positions are sorted and deduplicated, and each
        surviving position adds its single bit to its lane in an int64
        accumulator — distinct bits in a lane sum to their OR (torch has no
        scatter-OR).  Only the touched lanes are accumulated, so the
        transient is O(#positions).  ``bitmap=True`` keeps the bit-expanded
        path for exactness tests."""
        pos = pos.reshape(-1).to(torch.int64)
        if vals is not None:
            vals = vals.reshape(-1).to(torch.bool)
        if bitmap:
            temp = torch.zeros(self.layout.total_bits, dtype=torch.bool,
                               device=state.device)
            temp[pos if vals is None else pos[vals]] = True
            lanes = temp.reshape(-1, 32).to(torch.int64)
            shifts = torch.arange(32, dtype=torch.int64, device=state.device)
            return state | as_lanes((lanes << shifts).sum(dim=1))
        out = state.clone()
        if pos.numel() == 0:
            return out
        if vals is not None:
            pos = pos[vals]
        ps = torch.sort(pos).values
        keep = torch.ones_like(ps, dtype=torch.bool)
        keep[1:] = ps[1:] != ps[:-1]
        ps = ps[keep]
        lane = ps >> 5
        bit = torch.ones_like(ps) << (ps & 31)
        ulane, inv = torch.unique_consecutive(lane, return_inverse=True)
        acc = torch.zeros(ulane.shape[0], dtype=torch.int64,
                          device=state.device).index_add_(0, inv, bit)
        out[ulane] |= as_lanes(acc)
        return out

    def insert(self, state: torch.Tensor, keys) -> torch.Tensor:
        """Bulk insert via the lane-packed ``scatter_or``; exact w.r.t.
        duplicate positions.  The plain version of the insert kernel."""
        return self.scatter_or(state, self.positions(keys))

    def insert_online(self, state: torch.Tensor, keys) -> torch.Tensor:
        """Streaming insert (no O(m) temp): sequential read-modify-write OR,
        one position at a time.  Suited to small online batches."""
        pos = self.positions(keys)
        lane = (pos >> 5).reshape(-1).tolist()
        mask = as_lanes(torch.ones_like(pos) << (pos & 31)).reshape(-1)
        st = state.clone()
        for ln, m in zip(lane, mask):
            st[ln] = st[ln] | m
        return st

    def build(self, keys) -> torch.Tensor:
        return self.insert(self.init_state(), keys)

    # ------------------------------------------------------------------
    # point lookup
    # ------------------------------------------------------------------
    def point(self, state: torch.Tensor, ys) -> torch.Tensor:
        """Batched point lookup via the probe engine."""
        return self.engine.point_batched(state, self._keys(ys))

    def point_reference(self, state: torch.Tensor, ys) -> torch.Tensor:
        """Scalar-path point probe (per-key positions, AND of bits); the
        bit-identity oracle for the engine and the kernels."""
        pos = self.positions(ys)
        bits = (lanes_u32(state, pos >> 5) >> (pos & 31)) & 1
        return (bits == 1).all(dim=1)

    # ------------------------------------------------------------------
    # word-level probes (range machinery)
    # ------------------------------------------------------------------
    def _load_word(self, state, i: int, wordkey):
        """Load the layer-i word addressed by ``wordkey`` (= prefix >> (Δ-1)),
        AND-combined across replicas.  Returns (lo, hi) uint32 values in
        int64; hi == 0 for W <= 32."""
        lay = self.layout
        W = lay.word_bits(i)
        lo = torch.full_like(wordkey, _FULL)
        hi = torch.full_like(wordkey, _FULL if W == 64 else 0)
        for rep in range(lay.replicas[i]):
            bitoff = self._word_bitoff(i, rep, wordkey)
            lane = bitoff >> 5
            v = lanes_u32(state, lane)
            if W == 64:
                lo = lo & v
                hi = hi & lanes_u32(state, lane + 1)
            elif W == 32:
                lo = lo & v
            else:
                lo = lo & ((v >> (bitoff & 31)) & ((1 << W) - 1))
        return lo, hi

    def _bit_probe(self, state, i: int, x):
        """Single covering-bit probe at layer i for key x (replica-ANDed)."""
        lay = self.layout
        li = lay.levels[i]
        W = lay.word_bits(i)
        off = self._shr(x, li) & (W - 1)
        lo, hi = self._load_word(state, i,
                                 self._shr(x, li + lay.deltas[i] - 1))
        bit = (lo >> torch.clamp(off, max=31)) & 1
        if W == 64:
            bit_hi = (hi >> (torch.clamp(off, min=32) - 32)) & 1
            bit = torch.where(off < 32, bit, bit_hi)
        return bit != 0

    def _children_any(self, state, i: int, parent, qlo, qhi, nonempty):
        """Test whether any prefix in [qlo, qhi] (children of ``parent`` at
        layer i) has its bit set.  <= 2 word loads (the paper's PMHF payoff):
        a parent always has 2^Δ = 2W children, so exactly two words."""
        wa = self._load_word(state, i, parent << 1)
        wb = self._load_word(state, i, (parent << 1) | 1)
        return children_hit(self.layout.deltas[i], parent, qlo, qhi,
                            nonempty, wa, wb)

    # ------------------------------------------------------------------
    # exact-bitmap probes
    # ------------------------------------------------------------------
    def _exact_bit(self, state, prefix):
        pos = self._wrap(self.layout.exact_off_bits + prefix)
        return ((lanes_u32(state, pos >> 5) >> (pos & 31)) & 1) != 0

    def _exact_range_any(self, state, qlo, qhi, nonempty):
        """Any exact-bitmap bit set in prefix range [qlo, qhi]?

        The reference scans at most ``max_exact_scan_lanes`` lanes per query
        in a loop, and over-cap queries answer True (the paper's R-bound).
        Here the scan is batched: the two end lanes are masked and tested
        directly, and the lanes between them are answered by a prefix count
        of non-zero lanes over the exact segment."""
        lay = self.layout
        nbits = lay.exact_nbits
        qlo_c = u64.clamp(self._wrap(qlo), 0, nbits - 1)
        qhi_c = u64.clamp(self._wrap(qhi), 0, nbits - 1)
        p0 = lay.exact_off_bits + qlo_c
        p1 = lay.exact_off_bits + qhi_c
        lane0, lane1 = p0 >> 5, p1 >> 5
        b0, b1 = p0 & 31, p1 & 31
        over_cap = (lane1 - lane0 + 1) > lay.max_exact_scan_lanes
        same = lane0 == lane1
        hit = (lanes_u32(state, lane0)
               & _mask_u32(b0, torch.where(same, b1, 31))) != 0
        hit |= ~same & ((lanes_u32(state, lane1) & _mask_u32(0, b1)) != 0)
        e0 = lay.exact_off_bits >> 5
        e1 = (lay.exact_off_bits + nbits - 1) >> 5
        nz = (state[e0:e1 + 1] != 0).to(torch.int64)
        cnt = torch.cat([nz.new_zeros(1), torch.cumsum(nz, 0)])
        a = torch.clamp(lane0 + 1 - e0, 0, e1 - e0 + 1)   # first middle lane
        b = torch.clamp(lane1 - e0, 0, e1 - e0 + 1)       # one past the last
        hit |= (b > a) & ((cnt[b] - cnt[a]) > 0)
        return nonempty & (over_cap | (hit & (lane0 <= lane1)))

    # ------------------------------------------------------------------
    # range lookup: two-path dyadic decomposition (paper §4, Algorithm 1)
    # ------------------------------------------------------------------
    def _range_one(self, state, L, R):
        """The reference's scalar range lookup, batched over ``(B,)`` bounds
        with the same clip and select order."""
        lay = self.layout
        L, R = u64.minimum(L, R), u64.maximum(L, R)
        top = lay.top_level
        true = torch.ones_like(L, dtype=torch.bool)
        false = torch.zeros_like(true)

        if top >= lay.d:
            # levels cover the whole domain: single covering path from the top
            result, split = false, false
            left_alive, right_alive = true, false
        else:
            lt = self._shr(L, top)
            rt = self._shr(R, top)
            split = lt != rt
            if lay.has_exact:
                covL = self._exact_bit(state, lt)
                covR = self._exact_bit(state, rt)
                result = self._exact_range_any(
                    state, self._wrap(lt + 1), self._wrap(rt - 1),
                    u64.ge(rt - lt, 2))
                left_alive = covL
                right_alive = covR & split
            else:
                # saturated top levels omitted: a middle gap of >= 1 full
                # top-level DI is untestable -> conservative positive
                result = u64.ge(rt - lt, 2)
                left_alive = true
                right_alive = split

        for i in reversed(range(lay.k)):
            li = lay.levels[i]
            delta = lay.deltas[i]
            bottom = i == 0
            Lp = self._shr(L, li)
            Rp = self._shr(R, li)
            Lpar = self._shr(L, lay.levels[i + 1])
            Rpar = self._shr(R, lay.levels[i + 1])
            edge = 0 if bottom else 1

            # --- left path (doubles as the single pre-split path)
            l_end = (Lpar << delta) | ((1 << delta) - 1)
            l_qlo = self._wrap(Lp + edge)
            l_qhi = torch.where(split, l_end, self._wrap(Rp - edge))
            if bottom:
                l_nonempty = true
            else:
                l_nonempty = torch.where(split, Lp != l_end,
                                         u64.ge(Rp - Lp, 2))
            result = result | self._children_any(
                state, i, Lpar, l_qlo, l_qhi, l_nonempty & left_alive)

            # --- right path (only live after the split)
            r_start = Rpar << delta
            r_qhi = self._wrap(Rp - edge)
            r_nonempty = true if bottom else (Rp != r_start)
            result = result | self._children_any(
                state, i, Rpar, r_start, r_qhi, r_nonempty & right_alive)

            # --- covering continuation (early-stop as mask AND)
            if not bottom:
                covL = self._bit_probe(state, i, L)
                covR = self._bit_probe(state, i, R)
                new_split = split | (Lp != Rp)
                nxt_left = left_alive & covL
                nxt_right = torch.where(split, right_alive,
                                        left_alive & new_split) & covR
                left_alive, right_alive, split = nxt_left, nxt_right, new_split

        return result

    def range(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        """Batched range lookup via the probe engine."""
        return self.engine.range_batched(state, self._keys(lo), self._keys(hi))

    def range_reference(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        """Scalar-path range lookup (``_range_one``); the bit-identity oracle
        for the engine and the kernels."""
        return self._range_one(state, self._keys(lo), self._keys(hi))

    # ------------------------------------------------------------------
    # cost accounting (fig. 12g)
    # ------------------------------------------------------------------
    def word_accesses_per_range_query(self) -> int:
        """Static word loads per range query under the deduped engine plan
        (paper: <= 4/layer, times replicas); exact layouts add the two exact
        covering bits plus one amortized lane for the middle scan."""
        lay = self.layout
        total = sum(4 * lay.replicas[i] for i in range(lay.k))
        if lay.has_exact and lay.top_level < lay.d:
            total += 3
        return total

    def word_accesses_per_point_query(self) -> int:
        lay = self.layout
        return sum(lay.replicas) + (1 if lay.has_exact else 0)
