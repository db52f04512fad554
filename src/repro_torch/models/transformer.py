"""Dense decoder-only transformer (llama/qwen/granite family) and the
pixtral-style VLM variant (stub vision frontend: precomputed patch
embeddings prepended to the token sequence).

Counterpart of ``repro/models/transformer.py``, eager.  The
API is the reference's functional one: a params tree of tensors is passed
to every call, so the port's ``train/checkpoint.py`` saves and restores
exactly this tree and either package opens the other's checkpoints.

  table()                      -- parameter table (shapes + logical axes)
  init(generator)              -- materialized params on the model's device
  loss(params, batch)          -- scalar train loss (batch: tokens/labels/...)
  prefill(params, batch)       -- (last-token logits, kv cache)
  decode(params, cache, batch) -- (logits, new cache)
  input_specs(shape)           -- TensorSpecs (shape, dtype) of the inputs
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.bloomrf import resolve_device
from .act import remat
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import KVCache, dense_block, dense_block_decode, rmsnorm
from .params import P, init_params, tree_map

__all__ = ["DenseModel", "TensorSpec"]


class TensorSpec(NamedTuple):
    """The shape and dtype of one input or cache tensor."""
    shape: tuple
    dtype: torch.dtype


def stack_layers(table: dict, n: int) -> dict:
    """Prepend a stacked 'layers' dim to every leaf of a block table."""
    return tree_map(
        lambda p: P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale),
        table, is_leaf=lambda x: isinstance(x, P))


def attn_table(cfg: ModelConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = {
        "wq": P((D, H, hd), ("embed", "heads", None)),
        "wk": P((D, Hkv, hd), ("embed", "kv", None)),
        "wv": P((D, Hkv, hd), ("embed", "kv", None)),
        "wo": P((H, hd, D), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        t["bq"] = P((H, hd), ("heads", None), "zeros")
        t["bk"] = P((Hkv, hd), ("kv", None), "zeros")
        t["bv"] = P((Hkv, hd), ("kv", None), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = P((hd,), (None,), "ones")
        t["k_norm"] = P((hd,), (None,), "ones")
    return t


def mlp_table(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {
        "w_gate": P((D, F), ("embed", "mlp")),
        "w_up": P((D, F), ("embed", "mlp")),
        "w_down": P((F, D), ("mlp", "embed")),
    }


def block_table(cfg: ModelConfig) -> dict:
    return {
        "attn": attn_table(cfg),
        "mlp": mlp_table(cfg),
        "ln1": P((cfg.d_model,), (None,), "ones"),
        "ln2": P((cfg.d_model,), (None,), "ones"),
    }


def cross_entropy(logits, labels, mask=None):
    """CE over the vocab with f32 reductions.  The max it subtracts is
    detached, as the reference's ``stop_gradient``: its gradient is zero
    in exact arithmetic, and ``amax``'s backward would split it across
    tied maxima."""
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


class DenseModel:
    family = "dense"

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.adtype = getattr(torch, cfg.dtype)   # bfloat16 | float32
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def table(self) -> dict:
        cfg = self.cfg
        t = {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=0.02),
            "layers": stack_layers(self.block_table(), cfg.n_layers),
            "ln_f": P((cfg.d_model,), (None,), "ones"),
        }
        if not cfg.tie_embeddings:
            t["lm_head"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
        return t

    def block_table(self) -> dict:
        return block_table(self.cfg)

    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Params drawn from ``generator`` (on the model's device)."""
        return init_params(self.table(), generator, dtype, self.device)

    # ------------------------------------------------------------------
    # blocks (overridden by MoE)
    # ------------------------------------------------------------------
    def apply_block(self, p, x, *, positions, q_offset=0):
        x, kv = dense_block(p, self.cfg, x, positions=positions,
                            q_offset=q_offset)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, kv, aux  # (x, kv, aux_loss)

    def apply_block_decode(self, p, x, cache, pos):
        return dense_block_decode(p, self.cfg, x, cache, pos)

    # ------------------------------------------------------------------
    # forward passes
    # ------------------------------------------------------------------
    def _input(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _embed(self, params, batch):
        cfg = self.cfg
        tokens = self._input(batch["tokens"]).long()
        # gather, then cast: the reference's cast-then-gather, same values
        x = params["embed"][tokens].to(self.adtype)
        if cfg.family == "vlm":
            x = torch.cat([self._input(batch["patch_embeds"], self.adtype),
                           x], dim=1)
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device).expand(B, S)
        return x, positions

    def _backbone(self, params, x, positions, collect_cache: bool):
        cfg = self.cfg

        def body(x, lp):
            x, kv, a = self.apply_block(lp, x, positions=positions)
            return x, ((kv, a) if collect_cache else a)

        if cfg.remat:
            body = remat(body)
        x, ys = _act_scan(body, x, params["layers"])
        if collect_cache:
            kvs, auxs = ys
        else:
            kvs, auxs = None, ys
        return rmsnorm(x, params["ln_f"], cfg.norm_eps), auxs.sum(), kvs

    def _logits(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = params["embed"].to(self.adtype).T
        else:
            w = params["lm_head"].to(self.adtype)
        return torch.einsum("bsd,dv->bsv", x, w)

    def loss(self, params, batch):
        cfg = self.cfg
        x, positions = self._embed(params, batch)
        x, aux, _ = self._backbone(params, x, positions, collect_cache=False)
        if cfg.family == "vlm":  # loss only on text positions
            x = x[:, cfg.n_patches:]
        logits = self._logits(params, x)
        return cross_entropy(logits, self._input(batch["labels"])) + \
            0.01 * aux

    def prefill(self, params, batch):
        x, positions = self._embed(params, batch)
        x, _, kvs = self._backbone(params, x, positions, collect_cache=True)
        logits = self._logits(params, x[:, -1:])
        return logits, kvs  # kvs: (k, v) stacked over layers

    def decode(self, params, cache, batch):
        """batch: {"token": (B, 1) int, "pos": int}; cache: (k, v), each
        (L, B, S, kv_cache_heads, hd)."""
        cfg = self.cfg
        token = self._input(batch["token"]).long()
        x = params["embed"][token].to(self.adtype)
        pos = int(batch["pos"])

        def body(x, inp):
            lp, ck, cv = inp
            x, c2 = self.apply_block_decode(lp, x, KVCache(ck, cv), pos)
            return x, (c2.k, c2.v)

        x, new_cache = _act_scan(body, x,
                                 (params["layers"], cache[0], cache[1]))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), new_cache

    # ------------------------------------------------------------------
    # shapes
    # ------------------------------------------------------------------
    def text_len(self, shape: Shape) -> int:
        if self.cfg.family == "vlm" and shape.kind == "train":
            return shape.seq - self.cfg.n_patches
        return shape.seq

    def input_specs(self, shape: Shape) -> dict:
        cfg = self.cfg
        B = shape.batch
        i32 = torch.int32
        if shape.kind in ("train", "prefill"):
            spec = {"tokens": TensorSpec((B, self.text_len(shape)), i32)}
            if shape.kind == "train":
                spec["labels"] = TensorSpec((B, self.text_len(shape)), i32)
            if cfg.family == "vlm":
                spec["patch_embeds"] = TensorSpec(
                    (B, cfg.n_patches, cfg.d_model), self.adtype)
            return spec
        return {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}

    def cache_specs(self, shape: Shape) -> tuple:
        cfg = self.cfg
        shp = (cfg.n_layers, shape.batch, shape.seq, cfg.kv_cache_heads,
               cfg.hd)
        return (TensorSpec(shp, self.adtype), TensorSpec(shp, self.adtype))
