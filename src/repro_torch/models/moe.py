"""Mixture-of-Experts decoder (moonlight/granite-moe family).

Counterpart of ``repro/models/moe.py``, eager.  Dispatch is
capacity-based and group-local: tokens are grouped (a group is at most
``_GROUP`` tokens of one sequence), each token's top-k experts are ranked
by a group-local cumulative count, tokens past an expert's capacity are
dropped, and the rest are scattered into a (groups, experts*capacity, d)
buffer that the expert FFNs read as one batched einsum.  The Switch
load-balancing loss comes back beside the output.

Under an activation mesh (``act.activation_mesh``) the layer runs on
each rank's batch rows.  With ``moe_shard_dim == "expert"`` and the
experts dividing the "model" axis it takes the expert-parallel dispatch
(the reference's ``_expert_apply_ep``): each model rank owns E/n
contiguous experts, scatters only their (token, k) slots into a local
buffer, runs their FFNs and gathers its slots, and one all-reduce over
the model group combines the ranks' partial sums (the reference's
``psum`` under ``shard_map``).  With ``"mlp"`` each model rank owns F/n
of every expert's hidden units, as GSPMD splits the reference's, and the
same all-reduce combines them.  With no mesh the dispatch is local.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .act import (constrain, current_mesh, from_local, grad_summed,
                  is_dtensor, local_param, local_shard, row_placements)
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


def _experts(xg, keep, slot, wts, C: int, wg, wu, wd):
    """The capacity dispatch of grouped tokens ``xg`` (G, Sg, D) to the
    E_l experts whose FFN weights are ``wg`` / ``wu`` (E_l, D, F) and
    ``wd`` (E_l, F, D): each kept (token, k) slot (``slot`` in [0, E_l*C))
    is scattered into a (G, E_l*C, D) buffer, the FFNs run as batched
    einsums, and each slot's output is gathered back and summed over k by
    its gate weight ``wts`` (0 where the slot is not kept)."""
    G, Sg, D = xg.shape
    dt = xg.dtype
    E_l = wg.shape[0]
    xk = xg[:, :, None, :] * keep[..., None].to(dt)       # (G,Sg,K,D)
    gidx = torch.arange(G, device=xg.device)[:, None, None].expand_as(slot)
    # slots collide only where a zeroed row (a dropped token's, or under
    # expert parallelism another rank's) lands on a slot, so the
    # accumulation is exact in any order
    buf = torch.zeros((G, E_l * C, D), dtype=dt, device=xg.device)
    buf.index_put_((gidx, slot), xk, accumulate=True)
    buf = buf.reshape(G, E_l, C, D)
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, wg))
    h = h * torch.einsum("gecd,edf->gecf", buf, wu)
    y = torch.einsum("gecf,efd->gecd", h, wd)
    yk = y.reshape(G, E_l * C, D)[gidx, slot]             # (G,Sg,K,D) gather
    return (yk * wts[..., None]).sum(dim=2)


def _dispatch(p, cfg: ModelConfig, xg):
    """(aux, keep, slot, wts, C) of grouped tokens ``xg``."""
    G, Sg, _ = xg.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    r = route(p, cfg, xg)
    C = r.capacity
    # Switch aux loss: E * sum_e f_e * P_e (the counts are exact in f32)
    f = torch.zeros((G, E), dtype=torch.float32, device=xg.device)
    f.scatter_add_(1, r.topi.reshape(G, Sg * K),
                   torch.ones((G, Sg * K), device=xg.device)).div_(Sg * K)
    aux = (E * (f * r.probs.mean(dim=1)).sum(-1)).mean()
    keep = r.rank < C
    slot = r.topi * C + torch.clamp(r.rank, max=C - 1)    # (G,Sg,K) in [0,EC)
    wts = (r.topv * keep).to(xg.dtype)                    # (G,Sg,K)
    return aux, keep, slot, wts, C


def moe_mlp(p, cfg: ModelConfig, x):
    """x: (B, S, D) -> (y, aux_loss)."""
    if is_dtensor(x):
        return _moe_sharded(p, cfg, x)
    B, S, D = x.shape
    Sg = min(_GROUP, S)
    xg = x.reshape((B * S) // Sg, Sg, D)
    aux, keep, slot, wts, C = _dispatch(p, cfg, xg)
    dt = x.dtype
    out = _experts(xg, keep, slot, wts, C, cast(p["w_gate"], dt),
                   cast(p["w_up"], dt), cast(p["w_down"], dt))
    out = out.reshape(B, S, D)
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], x)
    return out, aux.float()


def _moe_sharded(p, cfg: ModelConfig, x):
    """``moe_mlp`` of a DTensor ``x`` on each rank's batch rows (a group
    is a slice of one sequence, so routing, capacity ranks and the aux
    loss are each rank's own groups'; the aux loss is their mean over the
    batch ranks).  The experts run split over "model" where it divides
    them (``_expert_apply_split``), else whole on every model rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, _ = current_mesh()
    model = tuple(mesh.mesh_dim_names).index("model")
    n = mesh.size(model)
    B, S, D = x.shape
    Sg = min(_GROUP, S)
    pl = row_placements(B, None)
    whole = [Replicate()] * mesh.ndim
    xl = local_shard(x, pl)
    xg = xl.reshape((xl.shape[0] * S) // Sg, Sg, D)
    aux, keep, slot, wts, C = _dispatch(
        {"router": local_param(p["router"], whole, pl)}, cfg, xg)
    dt = x.dtype
    ep = cfg.moe_shard_dim == "expert"
    if (cfg.n_experts if ep else cfg.d_ff) % n == 0:
        part = _expert_apply_split(p, xg, keep, slot, wts, C, mesh, model,
                                   pl, ep)
        partial = tuple(Partial() if i == model else q
                        for i, q in enumerate(pl))
        out = from_local(part.reshape(xl.shape), mesh, partial,
                         x.shape).redistribute(mesh, pl)
    else:
        w = [local_param(p[k], whole, pl).to(dt)
             for k in ("w_gate", "w_up", "w_down")]
        out = from_local(_experts(xg, keep, slot, wts, C, *w)
                         .reshape(xl.shape), mesh, pl, x.shape)
    if cfg.n_shared_experts:
        out = out + swiglu(p["shared"], x)
    # the mean over all groups: each batch rank's mean over its own,
    # divided by the ranks, is a partial sum (a Partial("avg") would hand
    # each rank the whole gradient)
    ranks = 1
    for i, q in enumerate(pl):
        ranks *= mesh.size(i) if isinstance(q, Shard) else 1
    aux_pl = [Partial() if isinstance(q, Shard) else Replicate() for q in pl]
    return out, from_local(aux.float() / ranks, mesh, aux_pl, ())


def _expert_apply_split(p, xg, keep, slot, wts, C: int, mesh, model: int,
                        rows, ep: bool):
    """The experts of this rank's groups ``xg`` split over the model axis
    of n ranks, their weights gathered whole over the batch axes.  With
    ``ep`` (the reference's ``_expert_apply_ep``) model rank r owns
    experts [r*E_l, (r+1)*E_l), E_l = E/n, and scatters only those
    experts' slots into a local (G_l, E_l*C, D) buffer; else (the
    reference's "mlp" sharding, which GSPMD partitions) it owns F/n of
    every expert's hidden units and runs every slot.  Returns this rank's
    partial sum, which the caller all-reduces over the model group (a
    Partial -> Replicate redistribution, whose backward hands each rank
    the whole gradient)."""
    from torch.distributed.tensor import Replicate, Shard

    dt = xg.dtype
    wg, wu, wd = (local_param(p[k], tuple(
        Shard(0 if ep else d) if i == model else Replicate()
        for i in range(mesh.ndim)), rows).to(dt)
        for k, d in (("w_gate", 2), ("w_up", 2), ("w_down", 1)))
    # each model rank's gradient of the tokens and gate weights covers
    # only its own experts' slots or hidden units: summed over the group
    # (before the slots of other ranks' experts are masked out below)
    xg, wts = (grad_summed(t, mesh, rows, model) for t in (xg, wts))
    if ep:
        # this rank's slots, renumbered from 0; the others' are not kept
        slot = slot - mesh.get_local_rank(model) * wg.shape[0] * C
        keep = keep & (slot >= 0) & (slot < wg.shape[0] * C)
        slot = torch.where(keep, slot, 0)
        wts = torch.where(keep, wts, 0)
    return _experts(xg, keep, slot, wts, C, wg, wu, wd)


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
