"""Batched serving loop: prefill -> iterative decode with greedy or
temperature sampling, prefix-cache admission via the bloomRF index, and
fixed-slot batching.

Counterpart of ``repro/serve/decode.py``.  Greedy decoding (``argmax``)
gives the reference's tokens; temperature sampling draws from a
``torch.Generator`` seeded with ``seed``, a different stream from
``jax.random.categorical``'s, so sampled tokens differ from the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bloomrf import resolve_device
from ..models.params import tree_map
from .prefix_cache import PrefixCacheIndex, pack_key

__all__ = ["Request", "ServeLoop"]


@dataclasses.dataclass
class Request:
    session: int
    prompt: np.ndarray          # int32 tokens
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: Optional[list] = None


class ServeLoop:
    """Single-host serving loop over ``model.prefill`` / ``model.decode``
    on ``device`` (default ``"cuda"``); the prefix-cache index lives on the
    same device, so its lookups launch the stacked point kernel and its
    segments build through the insert kernel on a card."""

    def __init__(self, model, params, max_seq: int, batch_slots: int = 4,
                 prefix_chunk: int = 64, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.slots = batch_slots
        self.prefix_chunk = prefix_chunk
        self.index = PrefixCacheIndex(device=self.device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self._prefill = model.prefill
        self._decode = model.decode

    def _sample(self, logits, temperature):
        last = logits[:, -1, :]
        if temperature <= 0.0:
            return torch.argmax(last, dim=-1)
        probs = torch.softmax(last.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve a queue of requests with fixed-slot batching."""
        queue = list(requests)
        done: List[Request] = []
        while queue:
            batch = queue[:self.slots]
            queue = queue[self.slots:]
            self._serve_batch(batch)
            done.extend(batch)
        return done

    def _serve_batch(self, batch: List[Request]) -> None:
        B = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((B, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, -len(r.prompt):] = r.prompt  # left-pad
            # prefix-cache admission probe (whole chunks of the prompt)
            for c in range(len(r.prompt) // self.prefix_chunk):
                self.index.lookup(r.session, c)
        logits, cache = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)})
        cache = self._grow_cache(cache, plen)
        for r in batch:
            r.out_tokens = []
        nxt = self._sample(logits, batch[0].temperature)
        max_new = max(r.max_new_tokens for r in batch)
        for t in range(max_new):
            host = nxt.tolist()
            for i, r in enumerate(batch):
                if t < r.max_new_tokens:
                    r.out_tokens.append(int(host[i]))
            logits, cache = self._decode(
                self.params, cache, {"token": nxt[:, None].to(torch.int32),
                                     "pos": plen + t})
            nxt = self._sample(logits, batch[0].temperature)
        # freeze this batch's prompt chunks into a new prefix segment
        entries = {}
        for i, r in enumerate(batch):
            for c in range(len(r.prompt) // self.prefix_chunk):
                entries[pack_key(r.session, c)] = [i]  # page ids (demo)
        if entries:
            self.index.freeze_segment(entries)

    def _grow_cache(self, cache, plen: int):
        """Pad prefill caches (seq dim = plen) out to max_seq for decode."""
        pad_to = self.max_seq

        def grow(x):
            if x.ndim >= 3 and x.shape[2] == plen:  # (L,B,S,...) KV layout
                pad = [0, 0] * (x.ndim - 3) + [0, pad_to - plen]
                return F.pad(x, pad)
            return x

        return tree_map(grow, cache)
