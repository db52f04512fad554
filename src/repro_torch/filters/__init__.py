"""Baseline filters the paper evaluates against (§9), plus a common API.

A copy of ``repro.filters``.  All baselines are host-side numpy
implementations (they model CPU data structures) and stay on the host in
the port; bloomRF itself is the PyTorch/CUDA implementation in
``repro_torch.core`` and the kernels, adapted to the same API by
:class:`BloomRFAdapter` (over the façade, ``backend="auto"``).
"""
from .api import PointRangeFilter
from .bloom import BloomFilter
from .bloomrf_adapter import BloomRFAdapter
from .cuckoo import CuckooFilter
from .minmax import FencePointers
from .prefix_bloom import PrefixBloomFilter
from .rosetta import Rosetta
from .surf_lite import SuRFLite

__all__ = [
    "PointRangeFilter",
    "BloomFilter",
    "PrefixBloomFilter",
    "FencePointers",
    "Rosetta",
    "SuRFLite",
    "CuckooFilter",
    "BloomRFAdapter",
]
