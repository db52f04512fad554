"""Paged KV cache (vLLM-style pages: device tensors + host-side allocator).

Counterpart of ``repro/serve/kv_cache.py``.  Pages are (L, n_pages,
page_size, n_kv, hd) tensors on ``device``; sequences own pages via a
host-side page table.  ``gather_cache`` materializes the contiguous
(L, B, S, kv, hd) view for the decode step (one gather along the page
dim).  The allocator is a free list with reference counts so frozen
prefix segments (prefix_cache.py) can share pages copy-free.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bloomrf import resolve_device

__all__ = ["PagedKVCache"]


class PagedKVCache:
    def __init__(self, n_layers: int, n_pages: int, page_size: int,
                 n_kv: int, head_dim: int, dtype=torch.bfloat16,
                 device=None):
        self.device = resolve_device(device)
        shape = (n_layers, n_pages, page_size, n_kv, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=dtype, device=self.device)
        self.page_size = page_size
        self.n_pages = n_pages
        self.free: List[int] = list(range(n_pages))
        self.refs = np.zeros(n_pages, np.int32)
        self.tables: Dict[int, List[int]] = {}

    # -- allocator -------------------------------------------------------
    def alloc_seq(self, seq_id: int, n_tokens: int) -> List[int]:
        need = (n_tokens + self.page_size - 1) // self.page_size
        if len(self.free) < need:
            raise MemoryError("KV pool exhausted")
        pages = [self.free.pop() for _ in range(need)]
        for p in pages:
            self.refs[p] += 1
        self.tables[seq_id] = pages
        return pages

    def extend_seq(self, seq_id: int, n_tokens_now: int) -> None:
        pages = self.tables[seq_id]
        need = (n_tokens_now + self.page_size - 1) // self.page_size
        while len(pages) < need:
            p = self.free.pop()
            self.refs[p] += 1
            pages.append(p)

    def share_pages(self, seq_id: int, pages: List[int]) -> None:
        """Adopt frozen prefix pages (copy-on-write not needed: read-only)."""
        for p in pages:
            self.refs[p] += 1
        self.tables[seq_id] = list(pages) + self.tables.get(seq_id, [])

    def free_seq(self, seq_id: int) -> None:
        for p in self.tables.pop(seq_id, []):
            self.refs[p] -= 1
            if self.refs[p] == 0:
                self.free.append(p)

    # -- device ops ------------------------------------------------------
    def _index(self, rows) -> torch.Tensor:
        return torch.as_tensor(rows, dtype=torch.long, device=self.device)

    def write_prefill(self, seq_id: int, k_new, v_new) -> None:
        """k_new/v_new: (L, S, kv, hd) for one sequence."""
        S = k_new.shape[1]
        self.extend_seq(seq_id, S)
        pages = self.tables[seq_id]
        ps = self.page_size
        pad = (len(pages) * ps) - S
        idx = self._index(pages)
        for pool, new in ((self.k, k_new), (self.v, v_new)):
            new = F.pad(new.to(device=self.device, dtype=pool.dtype),
                        (0, 0, 0, 0, 0, pad))
            pool[:, idx] = new.reshape(new.shape[0], len(pages), ps,
                                       *new.shape[2:])

    def write_token(self, seq_id: int, pos: int, k_new, v_new) -> None:
        """k_new/v_new: (L, 1, kv, hd) single decoded token at ``pos``."""
        self.extend_seq(seq_id, pos + 1)
        page = self.tables[seq_id][pos // self.page_size]
        off = pos % self.page_size
        self.k[:, page, off] = k_new[:, 0].to(self.k.dtype)
        self.v[:, page, off] = v_new[:, 0].to(self.v.dtype)

    def gather_cache(self, seq_ids: List[int], max_pages: int):
        """(L, B, max_pages*page_size, kv, hd) contiguous view + lengths."""
        tables = []
        for sid in seq_ids:
            t = self.tables[sid][:max_pages]
            tables.append(t + [0] * (max_pages - len(t)))
        idx = self._index(tables)                            # (B, max_pages)
        k = self.k[:, idx]                                    # (L,B,P,ps,kv,hd)
        v = self.v[:, idx]
        L, B = k.shape[0], k.shape[1]
        S = max_pages * self.page_size
        return (k.reshape(L, B, S, *k.shape[4:]),
                v.reshape(L, B, S, *v.shape[4:]))
