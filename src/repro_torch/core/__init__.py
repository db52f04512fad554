"""bloomRF core in PyTorch: layout, hashing, the filter and its probe engine.

Counterpart of ``repro.core`` for key domains of up to 64 bits (int64
carriers; ``core/uint64.py`` holds their unsigned arithmetic), with the
dynamic-filter machinery of ``core/dynamic.py`` (deletion, aging, in-place
growth).
"""
from .bloomrf import BloomRF
from .codecs import (float32_to_u32, float64_to_u64, multiattr_insert_codes,
                     multiattr_range_for_a_eq_b_range, pack2, pack2x32,
                     string_point_code, string_range_bounds, u32_to_float32,
                     u64_to_float64, unpack2, unpack2x32)
from .dynamic import (CountingLanes, DeletableBloomRF, Generations,
                      clear_bits, promote_counts, promote_layout,
                      promote_state, promotion_factors)
from .engine import (PointPlan, ProbeEngine, RangePlan, StackedProbe,
                     stacked_probe)
from .hashing import dyadic_prefixes, key_dtype_for
from .layout import FilterLayout, basic_layout

__all__ = [
    "FilterLayout",
    "basic_layout",
    "BloomRF",
    "ProbeEngine",
    "RangePlan",
    "PointPlan",
    "StackedProbe",
    "stacked_probe",
    "dyadic_prefixes",
    "key_dtype_for",
    "float64_to_u64",
    "u64_to_float64",
    "float32_to_u32",
    "u32_to_float32",
    "string_point_code",
    "string_range_bounds",
    "pack2",
    "unpack2",
    "pack2x32",
    "unpack2x32",
    "multiattr_insert_codes",
    "multiattr_range_for_a_eq_b_range",
    # dynamic-filter machinery: deletion, aging, in-place growth
    "CountingLanes",
    "DeletableBloomRF",
    "Generations",
    "clear_bits",
    "promote_counts",
    "promote_layout",
    "promote_state",
    "promotion_factors",
]
