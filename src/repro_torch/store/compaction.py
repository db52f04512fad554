"""Leveled compaction: run merging and filter-state merging.

Counterpart of ``repro/store/compaction.py``.  Two invariants carry it:

* **Entry merge** — runs are merged newest-first; for every key only the
  newest occurrence survives (last-write-wins), and tombstones survive as
  markers unless the merge target is the store's bottom level.
* **Filter merge** — bloomRF state is a union-closed bitmap: the filter of
  ``A ∪ B`` under one layout is exactly ``state_A | state_B``.  So
  same-layout merges are one ``torch.bitwise_or``.  Cross-layout merges
  (the merged run graduates to a larger capacity class) either *promote*
  each source state in place (segment tiling, ``core/dynamic.py``: no key
  replay, no kernel launch; opt-in via ``allow_promote``) or re-insert the
  surviving keys through the store's build (the insert kernel).  Either
  way the merged filter covers a superset of the surviving keys.

  OR and promote merges never clear bits, so deleted keys' bits pile up
  and FPR drifts upward under churn.  The ``purge`` policy rebuilds from
  the surviving keys when the merge's dead-entry fraction exceeds
  ``purge_dead_frac``, washing every dead contribution out.

The promote decision compares float64 densities built from exact set-bit
counts of a host copy of each state (the reference's expression), so both
packages take the same branch for the same runs.

One deliberate difference from the reference: a quarantined source (its
filter block failed its checksum) never enters an OR or a promote merge;
the merge rebuilds from the keys instead.  The reference ORs a quarantined
run's decodable state into a merged run that is no longer quarantined,
so the flipped bits reach a trusted filter and point lookups miss stored
keys (ROADMAP C.6).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.dynamic import promote_state, promotion_factors
from ..core.layout import FilterLayout
from ..obs import trace as _obs_trace
from .run import Run

__all__ = ["merge_sorted_runs", "merge_filter_state"]


def merge_sorted_runs(runs: List[Run], drop_tombstones: bool = False
                      ) -> Tuple[np.ndarray, list, np.ndarray]:
    """Merge runs given newest-first into (keys, vals, tombs), keys sorted.

    For duplicate keys the newest occurrence wins.  With
    ``drop_tombstones`` the surviving tombstone entries are removed
    entirely (bottom-level merges only)."""
    if not runs:
        raise ValueError("nothing to merge")
    with _obs_trace.span("compaction/merge_runs", runs=len(runs)):
        return _merge_sorted_runs(runs, drop_tombstones)


def _merge_sorted_runs(runs, drop_tombstones):
    all_keys = np.concatenate([r.keys for r in runs])
    prec = np.concatenate([np.full(len(r.keys), i, np.int64)
                           for i, r in enumerate(runs)])
    # stable pick of the newest occurrence per key: sort by (key, precedence)
    order = np.lexsort((prec, all_keys))
    ks = all_keys[order]
    first = np.concatenate([[True], ks[1:] != ks[:-1]])
    sel = order[first]
    keys = all_keys[sel]
    all_tombs = np.concatenate([r.tombs for r in runs])
    tombs = all_tombs[sel]
    flat_vals: list = []
    for r in runs:
        flat_vals.extend(r.vals)
    if drop_tombstones:
        keep = ~tombs
        keys, tombs, sel = keys[keep], tombs[keep], sel[keep]
    vals = [flat_vals[i] for i in sel]
    return keys, vals, tombs


def _state_density(run: Run) -> float:
    """Fraction of set bits in the run's filter block: the exact count of a
    host copy, divided in float64 (numpy's mean of the unpacked bits)."""
    a = run.state_numpy()[..., : (run.layout.total_bits + 31) // 32]
    return float(np.unpackbits(a.view(np.uint8)).mean())


def _promotion_is_cheap(runs: List[Run], target_layout: FilterLayout,
                        n_keys: int, slack: float) -> bool:
    """Would promoting cost at most ``slack``x the per-layer density of a
    rebuild?

    A promoted segment answers queries at the *source* class's resolution,
    so OR-ing promoted states unions their densities: ``1 - prod(1 - d_i)``.
    A rebuild spreads the same keys over the full target space instead.
    Estimate the rebuild's density from the sources' own set bits per key
    and gate the promote on the ratio."""
    union_miss, set_bits_per_key = 1.0, []
    for r in runs:
        d = _state_density(r)
        if d >= 1.0:
            return False
        union_miss *= 1.0 - d
        set_bits_per_key.append(
            -r.layout.total_bits * np.log1p(-d) / max(len(r), 1))
    union_density = 1.0 - union_miss
    rebuild_density = 1.0 - np.exp(
        -n_keys * np.mean(set_bits_per_key) / target_layout.total_bits)
    return union_density <= slack * max(rebuild_density, 1e-9)


def merge_filter_state(runs: List[Run], target_layout: FilterLayout,
                       keys: np.ndarray,
                       build: Callable[[FilterLayout, np.ndarray],
                                       torch.Tensor],
                       *,
                       dead_frac: float = 0.0,
                       purge_dead_frac: Optional[float] = None,
                       allow_promote: bool = False,
                       promote_density_slack: Optional[float] = None
                       ) -> Tuple[torch.Tensor, str]:
    """Merged filter block for ``runs`` under ``target_layout``.

    Returns ``(state, how)`` with ``how`` one of:

    * ``"or"`` — every source already uses ``target_layout``: the union
      filter is the bitwise OR of the source states;
    * ``"promote"`` — every source is promotion-compatible with the target
      (``core.dynamic.promotion_factors``): each state is segment-tiled in
      place and the results ORed, no key replay (``allow_promote`` only;
      with ``promote_density_slack`` set, also subject to the density
      guard, :func:`_promotion_is_cheap`);
    * ``"rebuild"`` — surviving ``keys`` re-inserted through ``build``;
    * ``"purge"`` — ``dead_frac`` exceeded ``purge_dead_frac``, forcing the
      rebuild path to wash dead keys' bits out of the filter even when an
      OR or promote merge was available.
    """
    with _obs_trace.span("compaction/merge_filters", runs=len(runs)):
        return _merge_filter_state(runs, target_layout, keys, build,
                                   dead_frac, purge_dead_frac, allow_promote,
                                   promote_density_slack)


def _merge_filter_state(runs, target_layout, keys, build, dead_frac,
                        purge_dead_frac, allow_promote,
                        promote_density_slack):
    purge = purge_dead_frac is not None and dead_frac > purge_dead_frac
    if purge:
        return build(target_layout, keys), "purge"
    # a quarantined source's state failed its checksum: OR-ing or tiling it
    # would carry its flipped bits into a run that is trusted again
    usable = all(r.state is not None and not r.quarantined for r in runs)
    if usable and all(r.layout == target_layout for r in runs):
        state = runs[0].state
        for r in runs[1:]:
            state = torch.bitwise_or(state, r.state)
        return state, "or"
    if (allow_promote and usable
            and all(promotion_factors(r.layout, target_layout) is not None
                    for r in runs)
            and (promote_density_slack is None
                 or _promotion_is_cheap(runs, target_layout, len(keys),
                                        promote_density_slack))):
        state = promote_state(runs[0].state, runs[0].layout, target_layout)
        for r in runs[1:]:
            state = torch.bitwise_or(
                state, promote_state(r.state, r.layout, target_layout))
        return state, "promote"
    return build(target_layout, keys), "rebuild"
