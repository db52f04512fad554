"""Mamba2 (state-space duality / SSD) backbone, attention-free.

Counterpart of ``repro/models/mamba2.py``, eager.  The
chunked SSD scan (quadratic within ``ssm_chunk`` tokens, a linear state
recurrence across chunks) runs prefill; decode is the O(1) recurrent
state update.  Only ``ssm_groups == 1`` is supported (every SSM and hybrid
arch uses one B/C group).

Decode cache per layer: the SSM state (B, H, N, P) in f32 and the
depthwise-conv tails of the x/B/C streams, both constant in sequence
length: a serving loop keeps them as they are and grows only KV caches.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .act import (constrain, from_local, grad_summed, is_dtensor,
                  legacy_f32, local_param, local_shard, row_placements)
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import cast, embed, rmsnorm
from .params import PS, P
from .transformer import DenseModel, TensorSpec

__all__ = ["MambaModel", "mamba_block_table", "ssd_chunked", "mamba_block",
           "mamba_block_decode", "init_mamba_cache_specs"]


def mamba_block_table(cfg: ModelConfig) -> dict:
    D, din = cfg.d_model, cfg.d_inner
    H, N, ck = cfg.ssm_heads, cfg.ssm_state, cfg.conv_kernel
    if cfg.ssm_groups != 1:
        raise ValueError("only ssm_groups=1 is supported")
    return {
        "wz": P((D, din), ("embed", "ssm_inner")),
        "wx": P((D, din), ("embed", "ssm_inner")),
        "wb": P((D, N), ("embed", None)),
        "wc": P((D, N), ("embed", None)),
        "wdt": P((D, H), ("embed", None)),
        "dt_bias": P((H,), (None,), "dt_bias"),
        "a_log": P((H,), (None,), "a_log"),
        "d_skip": P((H,), (None,), "ones"),
        "conv_x": P((ck, din), (None, "ssm_inner")),
        "conv_b": P((ck, N), (None, None)),
        "conv_c": P((ck, N), (None, None)),
        "conv_bias_x": P((din,), ("ssm_inner",), "zeros"),
        "conv_bias_b": P((N,), (None,), "zeros"),
        "conv_bias_c": P((N,), (None,), "zeros"),
        "ln": P((D,), (None,), "ones"),
        "norm": P((din,), ("ssm_inner",), "ones"),
        "w_out": P((din, D), ("ssm_inner", "embed")),
    }


def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``), with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_depthwise_conv(x, w, b, tail=None):
    """x: (B, S, C); w: (ck, C); optional tail: (B, ck-1, C) from the cache.
    Returns (y, new_tail)."""
    ck = w.shape[0]
    if tail is not None:
        pad = torch.cat([tail.to(x.dtype), x], dim=1)
    else:
        pad = F.pad(x, (0, 0, ck - 1, 0))
    # Python's sum from 0: the reference's order of the taps
    y = sum(pad[:, i:i + x.shape[1], :] * cast(w[i], x.dtype)[None, None, :]
            for i in range(ck))
    y = y + cast(b, x.dtype)[None, None, :]
    new_tail = pad[:, -(ck - 1):, :] if ck > 1 else None
    return F.silu(y), new_tail


def ssd_chunked(xs, dt, A, Bm, Cm, chunk: int, initial_state=None):
    """xs: (B,S,H,P); dt: (B,S,H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B,S,N).  Returns (y: (B,S,H,P), final_state: (B,H,N,P))."""
    Bsz, S, H, Pd = xs.shape
    N = Bm.shape[-1]
    c = min(chunk, S)
    Sp = ((S + c - 1) // c) * c
    if Sp != S:
        # zero-pad to a chunk multiple: dt=0 -> decay 1 and zero contribution,
        # so the final state and real-position outputs are unaffected
        pad = Sp - S
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_real, S = S, Sp
    nc = S // c
    dtype = xs.dtype

    x_ = xs.reshape(Bsz, nc, c, H, Pd)
    dt_ = dt.reshape(Bsz, nc, c, H).float()
    B_ = Bm.reshape(Bsz, nc, c, N)
    C_ = Cm.reshape(Bsz, nc, c, N)
    a = dt_ * A[None, None, None, :]                      # (B,nc,c,H) <= 0
    a_cs = torch.cumsum(a, dim=2)

    # intra-chunk (quadratic within the chunk); labels: b=batch, c=chunk idx,
    # i/j=position within chunk, h=head, p=head dim, s=state dim.  Above the
    # diagonal exp(seg) may overflow to inf; the where picks 0 there.
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]  # (B,nc,c,c,H)
    causal = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                   device=xs.device))[None, None, :, :, None]
    if legacy_f32():
        # the reference's preferred_element_type=f32: exact f32 products
        CB = torch.einsum("bcis,bcjs->bcij", C_.float(), B_.float())
        decay = torch.where(causal, torch.exp(seg), 0.0)
        w = (CB[..., None] * decay * dt_[:, :, None, :, :]).to(dtype)
    else:
        CB = torch.einsum("bcis,bcjs->bcij", C_, B_)      # compute dtype
        decay = torch.where(causal, torch.exp(seg), 0.0).to(dtype)
        w = CB[..., None] * decay * dt_[:, :, None, :, :].to(dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, x_)

    # chunk-local final states
    sdec = torch.exp(a_cs[:, :, -1:, :] - a_cs)           # (B,nc,c,H)
    S_loc = torch.einsum("bcjh,bcjs,bcjhp->bchsp", (sdec * dt_).to(dtype),
                         B_, x_)

    # inter-chunk recurrence, the state in f32
    chunk_decay = torch.exp(a_cs[:, :, -1, :]).float()   # (B,nc,H)
    state = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32,
                         device=xs.device)
             if initial_state is None else initial_state.float())
    prevs = []
    for i in range(nc):
        prevs.append(state)
        state = chunk_decay[:, i, :, None, None] * state + \
            S_loc[:, i].float()
    S_prevs = torch.stack(prevs, dim=1)                   # (B,nc,H,N,P)

    y_inter = torch.einsum("bcis,bcih,bchsp->bcihp", C_,
                           torch.exp(a_cs).to(dtype), S_prevs.to(dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    return y[:, :S_real], state


def _project(p, cfg: ModelConfig, x):
    """The block's input projections of rmsnorm(x): z, x, B, C, dt."""
    dt_ = x.dtype
    h = rmsnorm(x, p["ln"], cfg.norm_eps)
    return tuple(torch.einsum("bsd,de->bse", h, cast(p[k], dt_))
                 for k in ("wz", "wx", "wb", "wc", "wdt"))


def _gate_out(p, cfg: ModelConfig, x, y, z):
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + torch.einsum("bse,ed->bsd", y, cast(p["w_out"], x.dtype))


# the block's weights whose last (conv, projections) or only (biases, the
# gated norm) or first (the output projection) dim is a d_inner channel
_CHANNEL_DIM = {"wz": 1, "wx": 1, "conv_x": 1, "conv_bias_x": 0, "norm": 0,
                "w_out": 0}


def _channel_sharded(cfg: ModelConfig, p, x, cache=None):
    """``mamba_block`` (``cache`` None) or ``mamba_block_decode`` of a
    DTensor ``x`` on local tensors, its d_inner channels split over
    "model" as the reference's ``ssm_inner`` sharding splits them.

    Model rank r owns channels [r*c, (r+1)*c), c = d_inner / n: its
    columns of wz / wx, rows of w_out and slices of the channel convs and
    the gated norm, with B, C and dt computed whole.  A head can straddle
    two ranks (mamba2-130m's 24 heads over 16), so the SSD scan runs over
    *sub-heads* of gcd(head_dim, c) channels, each with its head's dt, A
    and D: every channel of a head evolves on its own, so the split is
    exact.  The gated norm's sum of squares and the output projection are
    partial sums over "model" (one all-reduce each); the input's and the
    whole weights' gradients are too.  Each rank runs its batch rows.
    Cache: tail_x split by channel, tail_b / tail_c whole, the state
    (B, H, N, P) split by heads where n divides H, else whole (its
    channels all-gathered)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    model = names.index("model") if "model" in names else None
    n = mesh.size(model) if model is not None else 1
    din, H, Pd, N = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    if din % n:
        raise ValueError(f"d_inner {din} does not divide the model axis {n}")
    r = mesh.get_local_rank(model) if n > 1 else 0
    c = din // n
    Ps = math.gcd(Pd, c)
    hid = torch.arange(r * c, (r + 1) * c, Ps, device=x.device) // Pd
    B, S = x.shape[0], x.shape[1]
    rows = row_placements(B)

    def on_model(q):           # ``rows`` with ``q`` on the model axis
        return tuple(q if i == model else p_ for i, p_ in enumerate(rows))

    # the computation is split over "model": a whole weight's gradient is
    # a partial sum there, as is the input's
    split = on_model(Shard(2))
    lp = {k: local_param(w, tuple(
        Shard(_CHANNEL_DIM[k]) if i == model and k in _CHANNEL_DIM
        else Replicate() for i in range(mesh.ndim)), split)
        for k, w in p.items()}
    xr = x.redistribute(mesh, rows)
    xl = grad_summed(xr.to_local(), mesh, rows, model)
    dt_ = x.dtype
    h = rmsnorm(xl, lp["ln"], cfg.norm_eps)
    z, xs, Bm, Cm = (torch.einsum("bsd,de->bse", h, lp[k].to(dt_))
                     for k in ("wz", "wx", "wb", "wc"))
    dtr = torch.einsum("bsd,de->bse", h, lp["wdt"][:, hid].to(dt_))
    tails = [None] * 3
    heads_split = H % n == 0
    if cache is not None:
        tails = [local_shard(cache["tail_x"], on_model(Shard(2))),
                 local_shard(cache["tail_b"], rows),
                 local_shard(cache["tail_c"], rows)]
        state = local_shard(cache["state"],
                            on_model(Shard(1)) if heads_split else rows)
        if not heads_split:    # this rank's channels as sub-heads
            state = state.permute(0, 2, 1, 3).reshape(-1, N, din)[
                ..., r * c:(r + 1) * c].reshape(-1, N, c // Ps, Ps).permute(
                    0, 2, 1, 3)
    xs, tail_x = _causal_depthwise_conv(xs, lp["conv_x"],
                                        lp["conv_bias_x"], tails[0])
    Bm, tail_b = _causal_depthwise_conv(Bm, lp["conv_b"],
                                        lp["conv_bias_b"], tails[1])
    Cm, tail_c = _causal_depthwise_conv(Cm, lp["conv_c"],
                                        lp["conv_bias_c"], tails[2])
    dt = softplus(dtr.float() + lp["dt_bias"][hid].float())
    A = -torch.exp(lp["a_log"][hid].float())
    Bl = xl.shape[0]
    xh = xs.reshape(Bl, S, c // Ps, Ps)
    if cache is None:
        y, state = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
        y = y + lp["d_skip"][hid].to(dt_)[None, None, :, None] * xh
    else:
        y, state = _ssd_step(dt[:, 0], A, Bm[:, 0], Cm[:, 0], xh[:, 0],
                             lp["d_skip"][hid], state)
        y = y[:, None].to(dt_)
    g = y.reshape(Bl, S, c) * F.silu(z)
    gf = g.float()
    # the gated norm's sum over all channels, read by each rank's own
    # channels: its gradient is a partial sum over "model" too
    ss = from_local((gf * gf).sum(-1), mesh, on_model(Partial()),
                    (B, S)).redistribute(mesh, rows).to_local(
                        grad_placements=on_model(Partial()))
    scale = torch.rsqrt(ss / din + cfg.norm_eps)
    g = g * scale[..., None].to(dt_) * lp["norm"].to(dt_)
    part = torch.einsum("bse,ed->bsd", g, lp["w_out"].to(dt_))
    out = xr + from_local(part, mesh, on_model(Partial()),
                          x.shape).redistribute(mesh, rows)
    if not heads_split:        # gather the channels into (B, H, N, P)
        state = local_shard(from_local(
            state.permute(0, 2, 1, 3).reshape(Bl, N, c), mesh,
            on_model(Shard(2)), (B, N, din)), rows)
        state = state.reshape(Bl, N, H, Pd).permute(0, 2, 1, 3)
    st_pl = on_model(Shard(1)) if heads_split else rows
    return out, {
        "state": from_local(state.float(), mesh, st_pl, (B, H, N, Pd)),
        "tail_x": from_local(tail_x, mesh, on_model(Shard(2)),
                             (B, tail_x.shape[1], din)),
        "tail_b": from_local(tail_b, mesh, rows, (B,) + tail_b.shape[1:]),
        "tail_c": from_local(tail_c, mesh, rows, (B,) + tail_c.shape[1:])}


def _ssd_step(dt, A, Bv, Cv, xh, d_skip, state):
    """One recurrent step of the SSM: dt (B, H) post-softplus, A (H,),
    Bv / Cv (B, N), xh (B, H, P), state (B, H, N, P) f32.  Returns
    (y (B, H, P) f32, the new state)."""
    xh, Bv, Cv = xh.float(), Bv.float(), Cv.float()
    decay = torch.exp(dt * A[None, :])                             # (B,H)
    S_new = decay[:, :, None, None] * state + \
        torch.einsum("bh,bn,bhp->bhnp", dt, Bv, xh)
    y = torch.einsum("bn,bhnp->bhp", Cv, S_new)
    return y + d_skip.float()[None, :, None] * xh, S_new


def mamba_block(p, cfg: ModelConfig, x):
    """x: (B,S,D).  Returns (x_out, this layer's decode cache)."""
    if is_dtensor(x):
        return _channel_sharded(cfg, p, x)
    B, S, _ = x.shape
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    x = constrain(x, ("batch", None, None))
    z, xs, Bm, Cm, dtr = _project(p, cfg, x)

    xs, tail_x = _causal_depthwise_conv(xs, p["conv_x"], p["conv_bias_x"])
    Bm, tail_b = _causal_depthwise_conv(Bm, p["conv_b"], p["conv_bias_b"])
    Cm, tail_c = _causal_depthwise_conv(Cm, p["conv_c"], p["conv_bias_c"])

    dt = softplus(dtr.float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    y, S_fin = ssd_chunked(xs.reshape(B, S, H, Pd), dt, A, Bm, Cm,
                           cfg.ssm_chunk)
    y = y + cast(p["d_skip"], dt_)[None, None, :, None] * \
        xs.reshape(B, S, H, Pd)
    out = _gate_out(p, cfg, x, y.reshape(B, S, cfg.d_inner), z)
    return out, {"state": S_fin.float(), "tail_x": tail_x,
                 "tail_b": tail_b, "tail_c": tail_c}


def mamba_block_decode(p, cfg: ModelConfig, x, cache):
    """x: (B,1,D); cache entries per layer: state (B,H,N,P) f32 + conv tails."""
    if is_dtensor(x):
        return _channel_sharded(cfg, p, x, cache)
    B = x.shape[0]
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    dt_ = x.dtype
    z, xs, Bm, Cm, dtr = _project(p, cfg, x)

    xs, tail_x = _causal_depthwise_conv(xs, p["conv_x"], p["conv_bias_x"],
                                        tail=cache["tail_x"])
    Bm, tail_b = _causal_depthwise_conv(Bm, p["conv_b"], p["conv_bias_b"],
                                        tail=cache["tail_b"])
    Cm, tail_c = _causal_depthwise_conv(Cm, p["conv_c"], p["conv_bias_c"],
                                        tail=cache["tail_c"])

    dt = softplus(dtr.float() + p["dt_bias"].float())[:, 0]       # (B,H)
    A = -torch.exp(p["a_log"].float())
    y, S_new = _ssd_step(dt, A, Bm[:, 0], Cm[:, 0], xs.reshape(B, H, Pd),
                         p["d_skip"], cache["state"])
    out = _gate_out(p, cfg, x, y.reshape(B, 1, cfg.d_inner).to(dt_), z)
    return out, {"state": S_new, "tail_x": tail_x, "tail_b": tail_b,
                 "tail_c": tail_c}


def init_mamba_cache_specs(cfg: ModelConfig, n_layers: int, batch: int,
                           adtype) -> dict:
    H, Pd, N, ck = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.conv_kernel
    return {
        "state": TensorSpec((n_layers, batch, H, N, Pd), torch.float32),
        "tail_x": TensorSpec((n_layers, batch, ck - 1, cfg.d_inner), adtype),
        "tail_b": TensorSpec((n_layers, batch, ck - 1, N), adtype),
        "tail_c": TensorSpec((n_layers, batch, ck - 1, N), adtype),
    }


def mamba_cache_pspecs(batch_axes, kv_axes) -> dict:
    return {
        "state": PS(None, batch_axes, kv_axes, None, None),
        "tail_x": PS(None, batch_axes, None, kv_axes),
        "tail_b": PS(None, batch_axes, None, None),
        "tail_c": PS(None, batch_axes, None, None),
    }


class MambaModel(DenseModel):
    family = "ssm"

    def block_table(self) -> dict:
        return mamba_block_table(self.cfg)

    def apply_block(self, p, x, *, positions, q_offset=0):
        del positions, q_offset
        x, cache = mamba_block(p, self.cfg, x)
        return x, cache, torch.zeros((), dtype=torch.float32,
                                     device=x.device)

    def decode(self, params, cache, batch):
        cfg = self.cfg
        token = self._input(batch["token"]).long()
        x = embed(params["embed"], token).to(self.adtype)

        def body(x, inp):
            lp, c = inp
            return mamba_block_decode(lp, cfg, x, c)

        x, new_cache = _act_scan(body, x, (params["layers"], cache))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), new_cache

    def cache_specs(self, shape: Shape) -> dict:
        return init_mamba_cache_specs(self.cfg, self.cfg.n_layers,
                                      shape.batch, self.adtype)

    def cache_pspecs(self, shape: Shape, batch_axes, kv_axes):
        return mamba_cache_pspecs(batch_axes, kv_axes)
