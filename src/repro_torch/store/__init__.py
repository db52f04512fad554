"""LSM run-store with per-run bloomRF filter blocks, in PyTorch.

Counterpart of ``repro.store``: a mutable :class:`Memtable` flushes into
immutable sorted :class:`Run`s, each carrying a bloomRF filter block plus
min/max fences; leveled compaction merges runs and their filter state; and
the read path probes all live runs' filters at once over one flat state
(``core.engine.StackedProbe``, and the store-scan kernel for scans).  A
durable store logs every write to a CRC-framed WAL and checkpoints
checksummed snapshots behind an atomic manifest.
"""
from .compaction import merge_filter_state, merge_sorted_runs
from .faults import (FaultPlan, InjectedCrash, InjectedDispatchFault,
                     fault_seed_from_env)
from .integrity import read_manifest, run_checksums, write_manifest
from .memtable import TOMBSTONE, Memtable
from .run import Run
from .store import Store, StoreConfig, StoreStats
from .wal import WAL_FILENAME, Wal

__all__ = [
    "Memtable",
    "TOMBSTONE",
    "Run",
    "Store",
    "StoreConfig",
    "StoreStats",
    "merge_sorted_runs",
    "merge_filter_state",
    "Wal",
    "WAL_FILENAME",
    "FaultPlan",
    "InjectedCrash",
    "InjectedDispatchFault",
    "fault_seed_from_env",
    "run_checksums",
    "read_manifest",
    "write_manifest",
]
