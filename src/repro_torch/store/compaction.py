"""Leveled compaction: run merging and filter-state merging.

Counterpart of ``repro/store/compaction.py``.  Two invariants carry it:

* **Entry merge** — runs are merged newest-first; for every key only the
  newest occurrence survives (last-write-wins), and tombstones survive as
  markers unless the merge target is the store's bottom level.
* **Filter merge** — bloomRF state is a union-closed bitmap: the filter of
  ``A ∪ B`` under one layout is exactly ``state_A | state_B``.  So
  same-layout merges are one ``torch.bitwise_or``; cross-layout merges
  (the merged run graduates to a larger capacity class) re-insert the
  surviving keys.  The ``purge`` policy rebuilds from the surviving keys
  when too many merged entries are dead.

Promote merges (segment tiling with ``core/dynamic.py``, guarded by
``promote_max_hops`` and the density slack) are not ported yet (ROADMAP
A.2b): ``allow_promote=True`` raises.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.layout import FilterLayout
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
    * ``"rebuild"`` — surviving ``keys`` re-inserted through ``build``;
    * ``"purge"`` — ``dead_frac`` exceeded ``purge_dead_frac``, forcing the
      rebuild path to wash dead keys' bits out of the filter even when an
      OR merge was available.
    """
    if allow_promote:
        raise NotImplementedError(
            "promote merges are not ported yet (ROADMAP A.2b)")
    del promote_density_slack       # a promote-only knob
    purge = purge_dead_frac is not None and dead_frac > purge_dead_frac
    if purge:
        return build(target_layout, keys), "purge"
    if all(r.layout == target_layout and r.state is not None for r in runs):
        state = runs[0].state
        for r in runs[1:]:
            state = torch.bitwise_or(state, r.state)
        return state, "or"
    return build(target_layout, keys), "rebuild"
