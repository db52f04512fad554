"""Mixture-of-Experts decoder (moonlight/granite-moe family).

Counterpart of ``repro/models/moe.py``, eager.  Dispatch is
capacity-based and group-local: tokens are grouped (a group is at most
``_GROUP`` tokens of one sequence), each token's top-k experts are ranked
by a group-local cumulative count, tokens past an expert's capacity are
dropped, and the rest are scattered into a (groups, experts*capacity, d)
buffer that the expert FFNs read as one batched einsum.  The Switch
load-balancing loss comes back beside the output.

Only the reference's local dispatch is ported.  Its expert-parallel path
(``_expert_apply_ep``, a ``shard_map`` over the "model" axis) runs only
under an installed activation mesh, which the port gets with
``dist/sharding.py`` (ROADMAP A.11.5); until then every call dispatches
locally, as the reference does without a mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .act import constrain
from .config import ModelConfig
from .layers import attention, cast, decode_attention, rmsnorm, swiglu
from .params import P
from .transformer import DenseModel, attn_table

__all__ = ["MoEModel", "moe_table", "moe_mlp", "route", "Route"]

_GROUP = 512  # tokens per dispatch group


def moe_table(cfg: ModelConfig) -> dict:
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ax = ("expert", "embed", "mlp") if cfg.moe_shard_dim == "expert" else \
         (None, "embed", "mlp")
    t = {
        "router": P((D, E), ("embed", None)),
        "w_gate": P((E, D, F_), ax),
        "w_up": P((E, D, F_), ax),
        "w_down": P((E, F_, D), (ax[0], ax[2], ax[1])),
    }
    if cfg.n_shared_experts:
        t["shared"] = {
            "w_gate": P((D, cfg.n_shared_experts * F_), ("embed", "mlp")),
            "w_up": P((D, cfg.n_shared_experts * F_), ("embed", "mlp")),
            "w_down": P((cfg.n_shared_experts * F_, D), ("mlp", "embed")),
        }
    return t


class Route(NamedTuple):
    """One layer's routing of a (G, Sg, D) token grouping."""
    topv: torch.Tensor    # (G, Sg, K) f32 gate weights, renormalized
    topi: torch.Tensor    # (G, Sg, K) expert ids, by weight, ties low id
    probs: torch.Tensor   # (G, Sg, E) f32 router softmax
    rank: torch.Tensor    # (G, Sg, K) place in its expert's queue
    capacity: int         # C: slots an expert has in a group


def route(p, cfg: ModelConfig, xg) -> Route:
    """The router of one layer over grouped tokens ``xg`` (G, Sg, D)."""
    G, Sg, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    logits = torch.einsum("gsd,de->gse", xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k orders ties by the lower index; a stable descending sort
    # does too, where torch.topk promises no order
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # group-local rank of each (token, k) within its expert
    flat = topi.reshape(G, Sg * K)
    onehot = F.one_hot(flat, E)
    ranks = torch.cumsum(onehot, dim=1) - onehot          # (G, Sg*K, E)
    rank = torch.gather(ranks, 2, flat[..., None])[..., 0].reshape(G, Sg, K)
    C = max(int(Sg * K * cfg.moe_capacity_factor / E), K)
    return Route(topv, topi, probs, rank, C)


def moe_mlp(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    Sg = min(_GROUP, S)
    G = (B * S) // Sg
    xg = x.reshape(G, Sg, D)
    r = route(p, cfg, xg)
    C = r.capacity

    # Switch aux loss: E * sum_e f_e * P_e (the counts are exact in f32)
    f = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    f.scatter_add_(1, r.topi.reshape(G, Sg * K),
                   torch.ones((G, Sg * K), device=x.device)).div_(Sg * K)
    aux = (E * (f * r.probs.mean(dim=1)).sum(-1)).mean()

    keep = r.rank < C
    slot = r.topi * C + torch.clamp(r.rank, max=C - 1)    # (G,Sg,K) in [0,EC)
    dt = x.dtype
    wts = (r.topv * keep).to(dt)                          # (G,Sg,K)
    xk = xg[:, :, None, :] * keep[..., None].to(dt)       # (G,Sg,K,D)
    gidx = torch.arange(G, device=x.device)[:, None, None].expand_as(slot)
    # slots collide only where a dropped token's zeroed row lands on its
    # expert's last slot, so the accumulation is exact in any order
    buf = torch.zeros((G, E * C, D), dtype=dt, device=x.device)
    buf.index_put_((gidx, slot), xk, accumulate=True)
    buf = buf.reshape(G, E, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, cast(p["w_gate"], dt)))
    h = h * torch.einsum("gecd,edf->gecf", buf, cast(p["w_up"], dt))
    y = torch.einsum("gecf,efd->gecd", h, cast(p["w_down"], dt))
    yk = y.reshape(G, E * C, D)[gidx, slot]               # (G,Sg,K,D) gather
    out = (yk * wts[..., None]).sum(dim=2).reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], x)
    return out, aux.float()


class MoEModel(DenseModel):
    family = "moe"

    def block_table(self) -> dict:
        cfg = self.cfg
        return {
            "attn": attn_table(cfg),
            "moe": moe_table(cfg),
            "ln1": P((cfg.d_model,), (None,), "ones"),
            "ln2": P((cfg.d_model,), (None,), "ones"),
        }

    def apply_block(self, p, x, *, positions, q_offset=0):
        cfg = self.cfg
        x = constrain(x, ("batch", None, None))  # pin loop-carry sharding
        h, kv = attention(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                          positions=positions, q_offset=q_offset)
        x = x + h
        m, aux = moe_mlp(p["moe"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x + m, kv, aux

    def apply_block_decode(self, p, x, cache, pos):
        cfg = self.cfg
        h, cache = decode_attention(p["attn"], cfg,
                                    rmsnorm(x, p["ln1"], cfg.norm_eps),
                                    cache, pos)
        x = x + h
        m, _ = moe_mlp(p["moe"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x + m, cache
