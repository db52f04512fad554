"""bloomRF in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``repro`` (the JAX reference, which stays beside it).  The
front door is the same typed façade::

    import repro_torch

    f = repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32", n=100_000))
    f.insert(keys)                 # on "cuda" unless device="cpu" is given
    f.range(lo, hi)

    st = repro_torch.open_filter(repro_torch.FilterSpec(dtype="u32",
                                                        placement="store"))
    st.put(key, value)
    st.scan_many(los, his)         # the store-scan kernel prunes the runs

    tb = repro_torch.open_filter(repro_torch.FilterSpec(
        dtype="u32", placement="tenant", tenants=16, shards=4))
    tb.insert(tenants, keys)       # per-tenant rows, with meta rows
    tb.point(tenants, keys)        # one stacked point-kernel launch a chunk

This package imports ``torch`` and numpy, never ``jax`` and nothing of
``repro``.  Attribute access is lazy so ``import repro_torch`` stays cheap.
"""
from __future__ import annotations

__all__ = ["FilterSpec", "open_filter", "chunked_probe", "SingleFilter",
           "BankFilter", "TenantFilter", "TypedStore"]


def __getattr__(name: str):
    if name in __all__:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
