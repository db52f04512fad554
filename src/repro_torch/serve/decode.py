"""Batched serving loop: prefill -> iterative decode with greedy or
temperature sampling, prefix-cache admission via the bloomRF index, and
fixed-slot batching.

Counterpart of ``repro/serve/decode.py``.  The prefill cache grows to the
model's own decode cache shapes (``grow_cache``), where the reference pads
every leaf whose axis 2 equals the prompt length: that also pads a Mamba
state whose head count, or a conv tail whose ``conv_kernel - 1``, equals
the prompt length (ROADMAP C.7).  Greedy decoding (``argmax``)
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
from ..models.config import Shape
from ..models.params import tree_map
from .prefix_cache import PrefixCacheIndex, pack_key

__all__ = ["Request", "ServeLoop", "grow_cache"]


def grow_cache(model, cache, max_seq: int, batch: int):
    """A prefill cache padded at the end of each axis to the matching leaf
    of ``model.cache_specs`` at ``max_seq`` tokens: KV sequence axes grow,
    constant-size leaves (SSM states, conv tails, cross-attention KV) keep
    their shapes."""
    specs = model.cache_specs(Shape("serve", max_seq, batch, "decode"))

    def grow(x, spec):
        if tuple(x.shape) == tuple(spec.shape):
            return x
        short = [want - have for have, want in zip(x.shape, spec.shape)]
        if len(short) != x.ndim or min(short) < 0:
            raise ValueError(f"cache leaf {tuple(x.shape)} does not fit "
                             f"{tuple(spec.shape)}")
        pad = []
        for n in reversed(short):
            pad += [0, n]
        return F.pad(x, pad)

    return tree_map(grow, cache, specs)


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
        cache = grow_cache(self.model, cache, self.max_seq, B)
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
