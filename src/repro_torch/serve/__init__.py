"""Serving substrate of the port: the bloomRF prefix-cache index.  The
paged KV cache and the batched decode loop of ``repro.serve`` are ROADMAP
A.11."""
from .prefix_cache import PrefixCacheIndex, pack_key

__all__ = ["PrefixCacheIndex", "pack_key"]
