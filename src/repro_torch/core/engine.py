"""Plan -> gather -> combine probe engine, in plain PyTorch.

Counterpart of ``repro/core/engine.py``: ``ProbeEngine`` for one filter and
``StackedProbe`` for ``R`` filter rows in one flat state.

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
the same plan and combine in one thread's registers.  ``StackedProbe`` is
the plain version of the stacked and store-scan kernels
(``kernels/store_scan.py``), and the store's point-lookup path.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import uint64 as u64
from .bloomrf import _FULL, BloomRF, children_hit, lanes_u32

__all__ = ["ProbeEngine", "RangePlan", "PointPlan", "StackedProbe",
           "stacked_probe", "fence_mask"]


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
        the address math is ``BloomRF._load_word``'s."""
        W = self.lay.word_bits(i)
        slots = []
        for rep in range(self.lay.replicas[i]):
            bitoff = self.filt._word_bitoff(i, rep, wordkey)
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
        pos = self.filt._wrap(self.lay.exact_off_bits + prefix)
        col = len(cols)
        cols.append(pos >> 5)
        return col, pos & 31

    def plan_range(self, lo, hi) -> RangePlan:
        """Emit the per-query lane table for the two-path decomposition:
        per layer the child word pairs of the left and right parents."""
        f, lay = self.filt, self.lay
        lo, hi = f._wrap(lo), f._wrap(hi)
        L, R = u64.minimum(lo, hi), u64.maximum(lo, hi)
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
        f, lay = self.filt, self.lay
        li = lay.levels[i]
        W = lay.word_bits(i)
        off = f._shr(x, li) & (W - 1)
        b = (f._shr(x, li + lay.deltas[i] - 1) & 1) != 0
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
                    state, f._wrap(lt + 1), f._wrap(rt - 1),
                    u64.ge(rt - lt, 2))
                left_alive = covL
                right_alive = covR & split
            else:
                result = u64.ge(rt - lt, 2)
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
            l_qlo = f._wrap(Lp + edge)
            l_qhi = torch.where(split, l_end, f._wrap(Rp - edge))
            if bottom:
                l_nonempty = true
            else:
                l_nonempty = torch.where(split, Lp != l_end,
                                         u64.ge(Rp - Lp, 2))
            result = result | children_hit(
                delta, Lpar, l_qlo, l_qhi, l_nonempty & left_alive,
                words["LA"], words["LB"])

            # --- right path (only live after the split)
            r_start = Rpar << delta
            r_qhi = f._wrap(Rp - edge)
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


# ---------------------------------------------------------------------------
# multi-filter stacked plan: R filter rows, ONE gather
# ---------------------------------------------------------------------------

class StackedProbe:
    """Probe ``R`` stacked filter rows with one gather per query batch.

    The rows live in one flat ``int32`` lane vector; row ``r`` starts at
    lane ``bases[r]`` and is addressed by ``engines[r]`` (rows may use
    different layouts: an LSM store stacks runs of several capacity
    classes).  The plan emits every row's lane table with the row base
    folded in, concatenates them along the lane axis, and reads them with a
    single ``flat_state[lanes]`` of shape ``(B, sum_r A_r)``; each row is
    then combined exactly as :meth:`ProbeEngine.combine_range` would combine
    it alone.

    Rows are processed as maximal *spans* of consecutive rows sharing a
    layout.  Query bounds are shared across rows (``(B,)``) or per row
    (``(B, R)``).  Exact-bitmap layouts are rejected: their middle scan
    cannot join the static plan.  The probe runs on whatever device the
    flat state lies on; ``device`` is where the row bases live.
    """

    def __init__(self, engines: Tuple[ProbeEngine, ...],
                 bases: Tuple[int, ...], device=None):
        if not engines:
            raise ValueError("need at least one stacked row")
        if len(engines) != len(bases):
            raise ValueError(
                f"{len(engines)} engines vs {len(bases)} row bases")
        for e in engines:
            if e.lay.has_exact:
                raise ValueError(
                    "exact-bitmap layouts cannot be stacked (their bounded "
                    "middle scan is dynamic); use per-row engine probes")
            if e.filt.wide != engines[0].filt.wide:
                raise ValueError("stacked rows must share one key dtype")
        self.engines = tuple(engines)
        self.bases = tuple(int(b) for b in bases)
        self.R = len(engines)
        dev = torch.device(device) if device is not None \
            else engines[0].filt.device
        spans = []       # (engine, row0, row1, (1, G, 1) int64 row bases)
        for r, e in enumerate(self.engines):
            if spans and spans[-1][0].lay == e.lay:
                spans[-1] = (spans[-1][0], spans[-1][1], r + 1)
            else:
                spans.append((e, r, r + 1))
        self.spans = tuple(
            (e, r0, r1, torch.tensor(self.bases[r0:r1], dtype=torch.int64,
                                     device=dev).view(1, -1, 1))
            for e, r0, r1 in spans)
        #: columns of the one (B, A) range gather, summed over rows
        self.range_gather_width = sum(
            (r1 - r0) * e.range_gather_width for e, r0, r1, _ in self.spans)

    # -- bounds handling --------------------------------------------------
    def _bounds(self, a: torch.Tensor, r0: int, r1: int) -> torch.Tensor:
        """Span slice of shared ``(B,)`` or per-row ``(B, R)`` bounds."""
        if a.dim() == 1:
            return a[:, None].expand(a.shape[0], r1 - r0)
        if a.dim() != 2 or a.shape[1] != self.R:
            raise ValueError(f"bounds must be (B,) or (B, {self.R}), "
                             f"got {tuple(a.shape)}")
        return a[:, r0:r1]

    # -- fused probes ------------------------------------------------------
    def _range_all(self, flat_state: torch.Tensor, lo, hi) -> torch.Tensor:
        lo, hi = torch.atleast_1d(lo), torch.atleast_1d(hi)
        B = lo.shape[0]
        parts, plans = [], []
        for e, r0, r1, base in self.spans:
            plan = e.plan_range(self._bounds(lo, r0, r1),
                                self._bounds(hi, r0, r1))  # lanes (B, G, A)
            parts.append((plan.lanes + base).reshape(B, -1))
            plans.append(plan)
        g = lanes_u32(flat_state, torch.cat(parts, dim=-1))  # the one gather
        out, off = [], 0
        for (e, r0, r1, _), plan in zip(self.spans, plans):
            G, A = r1 - r0, e.range_gather_width
            gg = g[:, off:off + G * A].reshape(B, G, A)
            off += G * A
            out.append(e.combine_range(gg, plan))
        return torch.cat(out, dim=-1)                         # (B, R)

    def _point_all(self, flat_state: torch.Tensor, ys) -> torch.Tensor:
        ys = torch.atleast_1d(ys)
        B = ys.shape[0]
        parts, plans = [], []
        for e, r0, r1, base in self.spans:
            plan = e.plan_point(ys)                         # lanes/sh (B, P)
            parts.append((plan.lanes[:, None, :] + base).reshape(B, -1))
            plans.append(plan)
        g = lanes_u32(flat_state, torch.cat(parts, dim=-1))  # the one gather
        out, off = [], 0
        for (e, r0, r1, _), plan in zip(self.spans, plans):
            G, P = r1 - r0, plan.lanes.shape[-1]
            gg = g[:, off:off + G * P].reshape(B, G, P)
            off += G * P
            out.append((((gg >> plan.sh[:, None, :]) & 1) == 1).all(dim=-1))
        return torch.cat(out, dim=-1)                         # (B, R)

    def _touch_all(self, flat_state: torch.Tensor, kmin, kmax, lo, hi,
                   quarantine: Optional[torch.Tensor] = None):
        """Fence-fused range probe: the store's scan-pruning plane.

        ``kmin``/``kmax`` are per-row key fences (``(R,)`` int64 carriers,
        compared in the unsigned order).
        Returns ``(fence, touch)``, both ``(B, R)`` bool: ``fence`` is the
        overlap of the query with the row's key range and ``touch = fence &
        (verdict | quarantine)``.  A quarantined row's filter block failed
        its checksum, so its verdict is forced to "maybe" (fence-only
        pruning; a corrupt filter must never skip a run).  Bounds must
        already be clamped into the filters' key domain.  The plain version
        of the store-scan kernel."""
        lo, hi = torch.atleast_1d(lo), torch.atleast_1d(hi)
        fence = fence_mask(kmin, kmax, lo, hi)
        filt = self._range_all(flat_state, lo, hi)
        if quarantine is not None:
            filt = filt | quarantine.to(torch.bool)[None, :]
        return fence, fence & filt

    # the reference's jit'd entry points; here the same functions, eager
    range_all = _range_all
    point_all = _point_all
    touch_all = _touch_all


def fence_mask(kmin: torch.Tensor, kmax: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """``(B, R)`` bool: query ``[lo, hi]`` overlaps row ``[kmin, kmax]``,
    in the unsigned order of the carriers."""
    return u64.ge(hi[:, None], kmin[None, :]) & u64.le(lo[:, None],
                                                       kmax[None, :])


@functools.lru_cache(maxsize=None)
def _filter_for_layout(layout, device: torch.device) -> BloomRF:
    """Cached :class:`BloomRF` for a layout on a device (the filter holds no
    state; its methods run on the tensors they are given)."""
    return BloomRF(layout, device=device)


@functools.lru_cache(maxsize=None)
def stacked_probe(layouts: tuple, bases: tuple, device) -> StackedProbe:
    """Cached :class:`StackedProbe` for a row stack described by layouts:
    call sites that re-stack the same row mix (a store after each refresh)
    share one probe instance."""
    device = torch.device(device)
    engines = tuple(_filter_for_layout(lay, device).engine for lay in layouts)
    return StackedProbe(engines, bases, device)
