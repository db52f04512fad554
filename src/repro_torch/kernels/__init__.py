"""Hand-written CUDA kernels for bloomRF on Hopper: the single-filter path
(resident and partitioned tiers), the stacked probes and the store's
scan-pruning plane.

Each kernel's source is ``csrc/<name>.cu``, built by ``nvcc`` at its first
launch (``_build.py``); each wrapper launches it on CUDA tensors and takes
the kernel's plain PyTorch version on CPU tensors.  ``ref.py`` holds the
scalar-path oracles and ``ops.py`` the dispatcher.
"""
from .insert import insert_resident
from .ops import DEFAULT_VMEM_BUDGET_U32, FilterOps, read_vmem_budget_u32
from .probe import (DEFAULT_BLOCK_U32, DEFAULT_TILE, point_probe_partitioned,
                    point_probe_resident, point_probe_stacked_resident)
from .rangeprobe import (range_probe_partitioned, range_probe_resident,
                         range_probe_stacked_resident)
from .store_scan import build_run_stack, store_scan_probe, store_scan_probe_flat

__all__ = [
    "FilterOps",
    "DEFAULT_VMEM_BUDGET_U32",
    "read_vmem_budget_u32",
    "point_probe_resident",
    "point_probe_partitioned",
    "insert_resident",
    "range_probe_resident",
    "range_probe_partitioned",
    "point_probe_stacked_resident",
    "range_probe_stacked_resident",
    "store_scan_probe",
    "store_scan_probe_flat",
    "build_run_stack",
    "DEFAULT_TILE",
    "DEFAULT_BLOCK_U32",
]
