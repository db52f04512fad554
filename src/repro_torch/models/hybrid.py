"""Zamba2-style hybrid: Mamba2 backbone + *shared* full-attention blocks.

Counterpart of ``repro/models/hybrid.py``, eager.  Every
``attn_every`` SSM layers, one of ``n_shared_blocks`` shared dense
transformer blocks is applied (parameters reused across applications,
alternating).  Each application keeps its own KV cache.  Zamba2's per-
application LoRA deltas on the shared block are omitted, as in the
reference.
"""
from __future__ import annotations

import torch

from .act import remat
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import KVCache, dense_block, dense_block_decode, embed, rmsnorm
from .mamba2 import (init_mamba_cache_specs, mamba_block, mamba_block_decode,
                     mamba_block_table, mamba_cache_pspecs)
from .params import PS, P, tree_map
from .transformer import DenseModel, TensorSpec, block_table, stack_layers

__all__ = ["HybridModel"]


class HybridModel(DenseModel):
    family = "hybrid"

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                             f"multiple of attn_every {cfg.attn_every}")
        self.n_apps = cfg.n_layers // cfg.attn_every

    def table(self) -> dict:
        cfg = self.cfg
        t = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=0.02),
            "layers": stack_layers(mamba_block_table(cfg), cfg.n_layers),
            "shared": stack_layers(block_table(cfg), cfg.n_shared_blocks),
            "ln_f": P((cfg.d_model,), (None,), "ones"),
        }
        if not cfg.tie_embeddings:
            t["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return t

    # ------------------------------------------------------------------
    def _grouped(self, tree):
        """Stacked mamba layers (L, ...) -> (n_apps, attn_every, ...)."""
        return tree_map(lambda a: a.reshape(
            (self.n_apps, self.cfg.attn_every) + a.shape[1:]), tree)

    def _flat(self, tree):
        """(n_apps, attn_every, ...) -> (L, ...)."""
        return tree_map(lambda a: a.reshape(
            (self.cfg.n_layers,) + a.shape[2:]), tree)

    def _shared(self, params, app_i: int):
        return tree_map(lambda a: a[app_i % self.cfg.n_shared_blocks],
                        params["shared"])

    def _backbone(self, params, x, positions, collect_cache: bool):
        cfg = self.cfg
        grouped = self._grouped(params["layers"])

        def outer(x, inp):
            app_i, group_params = inp

            def inner(x, lp):
                x, c = mamba_block(lp, cfg, x)
                return x, (c if collect_cache else None)

            x, mcaches = _act_scan(inner, x, group_params)
            x, kv = dense_block(self._shared(params, int(app_i)), cfg, x,
                                positions=positions)
            return x, ((mcaches, kv) if collect_cache else None)

        if cfg.remat:
            outer = remat(outer)
        x, caches = _act_scan(outer, x, (torch.arange(self.n_apps),
                                         grouped))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, caches

    def prefill(self, params, batch):
        x, positions = self._embed(params, batch)
        x, _, (mcaches, kvs) = self._backbone(params, x, positions,
                                              collect_cache=True)
        logits = self._logits(params, x[:, -1:])
        return logits, {"ssm": self._flat(mcaches), "kv_k": kvs[0],
                        "kv_v": kvs[1]}

    def decode(self, params, cache, batch):
        cfg = self.cfg
        token = self._input(batch["token"]).long()
        x = embed(params["embed"], token).to(self.adtype)
        pos = int(batch["pos"])

        def outer(x, inp):
            app_i, gp, sc, ck, cv = inp

            def inner(x, lp_c):
                lp, c = lp_c
                return mamba_block_decode(lp, cfg, x, c)

            x, sc2 = _act_scan(inner, x, (gp, sc))
            x, kv2 = dense_block_decode(self._shared(params, int(app_i)),
                                        cfg, x, KVCache(ck, cv), pos)
            return x, (sc2, kv2.k, kv2.v)

        x, (ssm2, k2, v2) = _act_scan(
            outer, x, (torch.arange(self.n_apps),
                       self._grouped(params["layers"]),
                       self._grouped(cache["ssm"]), cache["kv_k"],
                       cache["kv_v"]))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), {"ssm": self._flat(ssm2),
                                         "kv_k": k2, "kv_v": v2}

    # ------------------------------------------------------------------
    def cache_specs(self, shape: Shape) -> dict:
        cfg = self.cfg
        kv = TensorSpec((self.n_apps, shape.batch, shape.seq,
                         cfg.kv_cache_heads, cfg.hd), self.adtype)
        return {
            "ssm": init_mamba_cache_specs(cfg, cfg.n_layers, shape.batch,
                                          self.adtype),
            "kv_k": kv,
            "kv_v": kv,
        }

    def cache_pspecs(self, shape: Shape, batch_axes, kv_axes):
        kv = PS(None, batch_axes, None, kv_axes, None)
        return {"ssm": mamba_cache_pspecs(batch_axes, kv_axes),
                "kv_k": kv, "kv_v": kv}
