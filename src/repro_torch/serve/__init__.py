"""Serving substrate of the port: paged KV cache, batched decode, and the
bloomRF prefix-cache index."""
from .decode import Request, ServeLoop, grow_cache
from .kv_cache import PagedKVCache
from .prefix_cache import PrefixCacheIndex, pack_key

__all__ = ["PagedKVCache", "PrefixCacheIndex", "Request", "ServeLoop",
           "grow_cache", "pack_key"]
