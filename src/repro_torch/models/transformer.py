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
  param_pspecs / batch_pspecs / cache_pspecs -- partition specs (``PS``)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.bloomrf import resolve_device
from .act import einsum as _einsum
from .act import (from_local, gather_fsdp, is_dtensor, local_shard, remat,
                  row_placements)
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import KVCache, dense_block, dense_block_decode, embed, rmsnorm
from .params import PS, P, init_params, pspecs, tree_map

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
    if is_dtensor(logits):
        return _sharded_cross_entropy(logits, labels, mask)
    lf = logits.float()
    m = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _sharded_cross_entropy(logits, labels, mask=None):
    """``cross_entropy`` of DTensor logits on local shards: each rank takes
    its batch rows and, where "model" divides the vocab, its vocab slice;
    the max is all-reduced (detached), the exponent sums and the gold
    logits are partial sums over "model" combined by one redistribution,
    and the mean is a partial sum over the batch axes, returned
    replicated."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = logits.device_mesh
    model = tuple(mesh.mesh_dim_names).index("model")
    B, S, V = logits.shape
    rows = row_placements(B, None)
    n = mesh.size(model)
    cols = tuple(Shard(2) if i == model and V % n == 0 else p
                 for i, p in enumerate(rows))
    lf = local_shard(logits, cols).float()
    lab = (local_shard(labels, rows) if is_dtensor(labels)
           else labels).long()
    m = lf.amax(-1, keepdim=True).detach()
    v_l, lo = lf.shape[-1], 0
    if cols[model] == Shard(2):
        dist.all_reduce(m, dist.ReduceOp.MAX, group=mesh.get_group(model))
        lo = mesh.get_local_rank(model) * v_l
    hit = (lab >= lo) & (lab < lo + v_l)
    gold = torch.gather(lf, -1, torch.where(hit, lab - lo, 0)[..., None])
    parts = torch.stack([torch.exp(lf - m).sum(-1),
                         torch.where(hit, gold[..., 0], 0.0)])
    if cols[model] == Shard(2):
        pl = [Partial() if i == model else (Shard(1) if p.is_shard() else p)
              for i, p in enumerate(rows)]
        whole = [Replicate() if i == model else q for i, q in enumerate(pl)]
        parts = local_shard(from_local(parts, mesh, pl, (2, B, S)), whole)
    nll = torch.log(parts[0]) + m[..., 0] - parts[1]
    if mask is not None:
        mk = (local_shard(mask, rows) if is_dtensor(mask) else mask).float()
        num, den = (nll * mk).sum(), mk.sum()
    else:
        num, den = nll.sum(), torch.tensor(float(B * S), device=nll.device)
    sums = [Partial() if p.is_shard() else Replicate() for p in rows]
    num = from_local(num, mesh, sums, ())
    if mask is None:
        return num.redistribute(mesh, [Replicate()] * mesh.ndim) / den
    den = from_local(den, mesh, sums, ())
    return num.redistribute(mesh, [Replicate()] * mesh.ndim) / torch.clamp(
        den.redistribute(mesh, [Replicate()] * mesh.ndim), min=1.0)


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

    def param_pspecs(self, mesh_shape: dict, fsdp_axes=("data",)):
        return pspecs(self.table(), mesh_shape, fsdp_axes=fsdp_axes)

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
        x = embed(params["embed"], tokens).to(self.adtype)
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
            w = gather_fsdp(params["embed"]).to(self.adtype).T
        else:
            w = gather_fsdp(params["lm_head"]).to(self.adtype)
        return _einsum("bsd,dv->bsv", x, w)

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
        x = embed(params["embed"], token).to(self.adtype)
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

    def batch_pspecs(self, shape: Shape, batch_axes) -> dict:
        spec = {}
        for k in self.input_specs(shape):
            if k == "pos":
                spec[k] = PS()
            elif k in ("patch_embeds", "frames"):
                spec[k] = PS(batch_axes, None, None)
            else:
                spec[k] = PS(batch_axes, None)
        return spec

    def cache_specs(self, shape: Shape) -> tuple:
        cfg = self.cfg
        shp = (cfg.n_layers, shape.batch, shape.seq, cfg.kv_cache_heads,
               cfg.hd)
        return (TensorSpec(shp, self.adtype), TensorSpec(shp, self.adtype))

    def cache_pspecs(self, shape: Shape, batch_axes, kv_axes) -> tuple:
        ps = PS(None, batch_axes, None, kv_axes, None)
        return (ps, ps)
