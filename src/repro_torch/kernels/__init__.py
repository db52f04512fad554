"""Hand-written CUDA kernels for bloomRF's single-filter path (Hopper).

Each kernel's source is ``csrc/<name>.cu``, built by ``nvcc`` at its first
launch (``_build.py``); each wrapper launches it on CUDA tensors and takes
the kernel's plain PyTorch version on CPU tensors.  ``ref.py`` holds the
scalar-path oracles and ``ops.py`` the dispatcher.
"""
from .insert import insert_resident
from .ops import DEFAULT_VMEM_BUDGET_U32, FilterOps, read_vmem_budget_u32
from .probe import point_probe_resident
from .rangeprobe import range_probe_resident

__all__ = [
    "FilterOps",
    "DEFAULT_VMEM_BUDGET_U32",
    "read_vmem_budget_u32",
    "point_probe_resident",
    "insert_resident",
    "range_probe_resident",
]
