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

import torch
import torch.nn.functional as F

from .act import constrain, legacy_f32
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import cast, rmsnorm
from .params import P
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


def mamba_block(p, cfg: ModelConfig, x):
    """x: (B,S,D).  Returns (x_out, this layer's decode cache)."""
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
    xh = xs.reshape(B, H, Pd).float()
    Bv = Bm[:, 0].float()                                          # (B,N)
    Cv = Cm[:, 0].float()
    decay = torch.exp(dt * A[None, :])                             # (B,H)
    S_new = decay[:, :, None, None] * cache["state"] + \
        torch.einsum("bh,bn,bhp->bhnp", dt, Bv, xh)
    y = torch.einsum("bn,bhnp->bhp", Cv, S_new)
    y = y + p["d_skip"].float()[None, :, None] * xh
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
        x = params["embed"][token].to(self.adtype)

        def body(x, inp):
            lp, c = inp
            return mamba_block_decode(lp, cfg, x, c)

        x, new_cache = _act_scan(body, x, (params["layers"], cache))
        x = rmsnorm(x, params["ln_f"], cfg.norm_eps)
        return self._logits(params, x), new_cache

    def cache_specs(self, shape: Shape) -> dict:
        return init_mamba_cache_specs(self.cfg, self.cfg.n_layers,
                                      shape.batch, self.adtype)
