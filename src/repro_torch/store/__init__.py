"""LSM run-store with per-run bloomRF filter blocks, in PyTorch.

Counterpart of ``repro.store``: a mutable :class:`Memtable` flushes into
immutable sorted :class:`Run`s, each carrying a bloomRF filter block plus
min/max fences; leveled compaction merges runs and their filter state; and
the read path probes all live runs' filters at once over one flat state
(``core.engine.StackedProbe``, and the store-scan kernel for scans).
"""
from .compaction import merge_filter_state, merge_sorted_runs
from .faults import FaultPlan, InjectedCrash, InjectedDispatchFault
from .integrity import run_checksums
from .memtable import TOMBSTONE, Memtable
from .run import Run
from .store import Store, StoreConfig, StoreStats

__all__ = [
    "Memtable",
    "TOMBSTONE",
    "Run",
    "Store",
    "StoreConfig",
    "StoreStats",
    "merge_sorted_runs",
    "merge_filter_state",
    "FaultPlan",
    "InjectedCrash",
    "InjectedDispatchFault",
    "run_checksums",
]
