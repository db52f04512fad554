"""Plan -> gather -> combine probe engine, in plain PyTorch.

Counterpart of ``repro/core/engine.py`` (``ProbeEngine``; ``StackedProbe``
comes with the store slice, ROADMAP A.3).

1. **plan** — a pass over the static layout emits, per query, the table of
   uint32 *lane* addresses the two-path dyadic decomposition needs.  The
   covering-bit word of ``x`` at layer ``i`` is always one of the two child
   words of ``x``'s parent, so covering probes cost no extra loads (4 word
   loads per layer per replica).
2. **gather** — one ``state[lanes]`` of shape ``(B, A)`` for the batch.
3. **combine** — the reference's live/dead path algebra on the gathered
   words, with the same hash formulas, mask algebra and clip/select order,
   so the verdicts equal ``BloomRF._range_one`` bit for bit.

Exact-bitmap layouts gather their two exact covering bits with the rest and
answer the middle of the range with ``BloomRF._exact_range_any``.

These are the plain versions of the point- and range-probe kernels
(``kernels/probe.py``, ``kernels/rangeprobe.py``): a CUDA kernel computes
the same plan and combine in one thread's registers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .bloomrf import _FULL, MASK32, BloomRF, children_hit, lanes_u32
from .hashing import mix

__all__ = ["ProbeEngine", "RangePlan", "PointPlan"]


class _Slot(NamedTuple):
    """One planned word load: column(s) in the lane table + extraction info."""

    col: int                         # first column in the (B, A) lane table
    sh: Optional[torch.Tensor]       # (B,) intra-lane bit shift (W < 32 only)


class RangePlan(NamedTuple):
    """Static-width address table + metadata for one range-query batch."""

    lanes: torch.Tensor              # (B, A) int64 — every state lane touched
    layers: tuple                    # per layer: {LA,LB,RA,RB: (slots...)}
    exact: Optional[tuple]           # ((col, sh) for L, (col, sh) for R)
    L: torch.Tensor                  # (B,) normalised query bounds
    R: torch.Tensor


class PointPlan(NamedTuple):
    lanes: torch.Tensor              # (B, P) int64
    sh: torch.Tensor                 # (B, P) int64


class ProbeEngine:
    """Layout-bound plan/gather/combine evaluator for a :class:`BloomRF`."""

    def __init__(self, filt: BloomRF):
        self.filt = filt
        self.lay = filt.layout
        self._seeds = filt.layout.seeds
        loads = 0
        width = 0
        for i in range(self.lay.k):
            per_word_lanes = 2 if self.lay.word_bits(i) == 64 else 1
            loads += 4 * self.lay.replicas[i]
            width += 4 * self.lay.replicas[i] * per_word_lanes
        if self.lay.has_exact and self.lay.top_level < self.lay.d:
            loads += 2
            width += 2
        #: word loads in the static range plan (4/layer/replica + exact bits)
        self.range_word_loads = loads
        #: columns of the (B, A) gather — lanes, not words (W=64 -> 2)
        self.range_gather_width = width

    # ------------------------------------------------------------------
    # plan
    # ------------------------------------------------------------------
    def _word_slots(self, i: int, wordkey, cols: list) -> Tuple[_Slot, ...]:
        """Plan the replica loads of the layer-``i`` word at ``wordkey``;
        the address math mirrors ``BloomRF._load_word``."""
        lay = self.lay
        W = lay.word_bits(i)
        offbits = lay.seg_off_bits[lay.seg_of_layer[i]]
        slots = []
        for rep in range(lay.replicas[i]):
            h = mix(wordkey, self._seeds[i, rep], lay.d)
            bitoff = (offbits + (h % lay.nwords(i)) * W) & MASK32
            lane = bitoff >> 5
            col = len(cols)
            cols.append(lane)
            if W == 64:
                cols.append(lane + 1)
                slots.append(_Slot(col, None))
            elif W == 32:
                slots.append(_Slot(col, None))
            else:
                slots.append(_Slot(col, bitoff & 31))
        return tuple(slots)

    def _exact_slot(self, prefix, cols: list):
        pos = (self.lay.exact_off_bits + prefix) & MASK32
        col = len(cols)
        cols.append(pos >> 5)
        return col, pos & 31

    def plan_range(self, lo, hi) -> RangePlan:
        """Emit the per-query lane table for the two-path decomposition:
        per layer the child word pairs of the left and right parents."""
        f, lay = self.filt, self.lay
        lo, hi = lo & MASK32, hi & MASK32
        L, R = torch.minimum(lo, hi), torch.maximum(lo, hi)
        cols: list = []
        layers = []
        for i in range(lay.k):
            Lpar = f._shr(L, lay.levels[i + 1])
            Rpar = f._shr(R, lay.levels[i + 1])
            layers.append({
                "LA": self._word_slots(i, Lpar << 1, cols),
                "LB": self._word_slots(i, (Lpar << 1) | 1, cols),
                "RA": self._word_slots(i, Rpar << 1, cols),
                "RB": self._word_slots(i, (Rpar << 1) | 1, cols),
            })
        exact = None
        if lay.has_exact and lay.top_level < lay.d:
            exact = (self._exact_slot(f._shr(L, lay.top_level), cols),
                     self._exact_slot(f._shr(R, lay.top_level), cols))
        return RangePlan(torch.stack(cols, dim=-1), tuple(layers), exact, L, R)

    def plan_point(self, ys) -> PointPlan:
        pos = self.filt.positions(ys)                      # (B, P)
        return PointPlan(pos >> 5, pos & 31)

    # ------------------------------------------------------------------
    # gather
    # ------------------------------------------------------------------
    def gather(self, state: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
        """The one load: every word for the batch in a single gather."""
        return lanes_u32(state, lanes)

    # ------------------------------------------------------------------
    # combine
    # ------------------------------------------------------------------
    def _word(self, g, i: int, slots):
        """Replica-ANDed (lo, hi) lanes of one planned word (cf. _load_word)."""
        W = self.lay.word_bits(i)
        lo = torch.full_like(g[..., 0], _FULL)
        hi = torch.full_like(lo, _FULL if W == 64 else 0)
        for s in slots:
            v = g[..., s.col]
            if W == 64:
                lo = lo & v
                hi = hi & g[..., s.col + 1]
            elif W == 32:
                lo = lo & v
            else:
                lo = lo & ((v >> s.sh) & ((1 << W) - 1))
        return lo, hi

    def _cov_bit(self, i: int, x, wa, wb):
        """Covering-bit probe served from the deduped child words: the word
        of ``x >> (l_i + Δ_i - 1)`` *is* child word A or B of ``x``'s parent,
        selected by the low parent-side bit — no extra load."""
        lay = self.lay
        li = lay.levels[i]
        W = lay.word_bits(i)
        off = (x >> li) & (W - 1)
        b = ((x >> (li + lay.deltas[i] - 1)) & 1) != 0
        lo = torch.where(b, wb[0], wa[0])
        bit = (lo >> torch.clamp(off, max=31)) & 1
        if W == 64:
            hi = torch.where(b, wb[1], wa[1])
            bit_hi = (hi >> (torch.clamp(off, min=32) - 32)) & 1
            bit = torch.where(off < 32, bit, bit_hi)
        return bit != 0

    def combine_range(self, g: torch.Tensor, plan: RangePlan,
                      state: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Branch-free verdicts from the gathered word matrix.

        ``state`` is only consulted for exact-bitmap layouts (the middle of
        the range is answered from the exact segment)."""
        f, lay = self.filt, self.lay
        L, R = plan.L, plan.R
        top = lay.top_level
        true = torch.ones_like(L, dtype=torch.bool)
        false = torch.zeros_like(true)

        if top >= lay.d:
            result, split = false, false
            left_alive, right_alive = true, false
        else:
            lt = f._shr(L, top)
            rt = f._shr(R, top)
            split = lt != rt
            if lay.has_exact:
                if state is None:
                    raise ValueError(
                        "exact-bitmap layouts need `state` for the middle "
                        "scan (combine_range(..., state=state))")
                (colL, shL), (colR, shR) = plan.exact
                covL = ((g[..., colL] >> shL) & 1) != 0
                covR = ((g[..., colR] >> shR) & 1) != 0
                result = f._exact_range_any(
                    state, (lt + 1) & MASK32, (rt - 1) & MASK32,
                    (rt - lt) >= 2)
                left_alive = covL
                right_alive = covR & split
            else:
                result = (rt - lt) >= 2
                left_alive = true
                right_alive = split

        for i in reversed(range(lay.k)):
            li = lay.levels[i]
            delta = lay.deltas[i]
            bottom = i == 0
            Lp = f._shr(L, li)
            Rp = f._shr(R, li)
            Lpar = f._shr(L, lay.levels[i + 1])
            Rpar = f._shr(R, lay.levels[i + 1])
            edge = 0 if bottom else 1
            words = {name: self._word(g, i, slots)
                     for name, slots in plan.layers[i].items()}

            # --- left path (doubles as the single pre-split path)
            l_end = (Lpar << delta) | ((1 << delta) - 1)
            l_qlo = (Lp + edge) & MASK32
            l_qhi = torch.where(split, l_end, (Rp - edge) & MASK32)
            if bottom:
                l_nonempty = true
            else:
                l_nonempty = torch.where(split, Lp != l_end, (Rp - Lp) >= 2)
            result = result | children_hit(
                delta, Lpar, l_qlo, l_qhi, l_nonempty & left_alive,
                words["LA"], words["LB"])

            # --- right path (only live after the split)
            r_start = Rpar << delta
            r_qhi = (Rp - edge) & MASK32
            r_nonempty = true if bottom else (Rp != r_start)
            result = result | children_hit(
                delta, Rpar, r_start, r_qhi, r_nonempty & right_alive,
                words["RA"], words["RB"])

            # --- covering continuation, bits from the gathered child words
            if not bottom:
                covL = self._cov_bit(i, L, words["LA"], words["LB"])
                covR = self._cov_bit(i, R, words["RA"], words["RB"])
                new_split = split | (Lp != Rp)
                nxt_left = left_alive & covL
                nxt_right = torch.where(split, right_alive,
                                        left_alive & new_split) & covR
                left_alive, right_alive, split = nxt_left, nxt_right, new_split

        return result

    def combine_point(self, g: torch.Tensor, plan: PointPlan) -> torch.Tensor:
        return (((g >> plan.sh) & 1) == 1).all(dim=-1)

    # ------------------------------------------------------------------
    # fused entry points (the plain versions of the probe kernels)
    # ------------------------------------------------------------------
    def range_batched(self, state: torch.Tensor, lo, hi) -> torch.Tensor:
        plan = self.plan_range(lo, hi)
        g = self.gather(state, plan.lanes)
        return self.combine_range(
            g, plan, state=state if self.lay.has_exact else None)

    def point_batched(self, state: torch.Tensor, ys) -> torch.Tensor:
        plan = self.plan_point(ys)
        return self.combine_point(self.gather(state, plan.lanes), plan)
