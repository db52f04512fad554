"""Shared neural-net layers: RMSNorm, RoPE, GQA attention (an online
softmax over KV blocks), SwiGLU/GELU MLPs, and the dense decoder block.

Counterpart of ``repro/models/layers.py``.  The reference's two custom
VJPs are ``torch.autograd.Function``s here: ``rmsnorm`` (its backward
keeps ``dx`` in the activation dtype, with f32 statistics only) and the
flash scan of train and prefill (its backward recomputes the scores one
KV block at a time from the saved ``(q, k, v, out, m, lse)``).  Both are
plain torch inside, as the reference's are plain JAX.

Conventions, as in the reference:
* params are f32 trees; activations compute in the config's dtype (bf16
  by default) with f32 softmax/normalization internals.  Where the
  reference multiplies with ``preferred_element_type=float32`` (the
  rmsnorm statistic, the scores and the PV sums of the flash scan), the
  operands are upcast to f32 first: a product of two bf16 values is exact
  in f32, so the sums are the reference's, not a bf16 product rounded;
* attention is an online-softmax scan over KV blocks of
  ``DEFAULT_KV_BLOCK`` keys (memory O(S * block) instead of O(S^2));
* GQA never materializes repeated KV heads (grouped einsum).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .act import constrain, legacy_f32
from .act import scan as _act_scan
from .config import ModelConfig

__all__ = [
    "rmsnorm", "rope", "flash_attention", "attention", "decode_attention",
    "swiglu", "gelu_mlp", "dense_block", "dense_block_decode", "KVCache",
]

DEFAULT_KV_BLOCK = 1024


def cast(x, dtype):
    return x.to(dtype) if x.dtype != dtype else x


def _rms_scale(x, eps):
    xf = x.float()
    ss = (xf * xf).sum(-1)
    return torch.rsqrt(ss / x.shape[-1] + eps)             # f32 (..., )


def _rmsnorm_fwd(x, w, eps):
    scale = _rms_scale(x, eps)
    return x * scale[..., None].to(x.dtype) * w.to(x.dtype), scale


def _rmsnorm_bwd(x, w, scale, dy):
    """d/dx [x_i * s(x) * w_i] with s = rsqrt(mean(x^2) + eps):
    dx = s * w * dy - x * s^3 / D * sum_j(dy_j * w_j * x_j), in x.dtype
    with the sum and s^3 in f32; dw sums dy * x * s over every leading
    axis in f32, cast to w.dtype."""
    dt = x.dtype
    dyw = dy * w.to(dt)
    inner = (dyw.float() * x.float()).sum(-1)          # f32 stats only
    coef = inner * scale ** 3 / x.shape[-1]
    dx = dyw * scale[..., None].to(dt) - x * coef[..., None].to(dt)
    xs = x * scale[..., None].to(dt)
    dw = (dy * xs).float().sum(tuple(range(x.ndim - 1))).to(w.dtype)
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        y, scale = _rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, scale)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx, dw = _rmsnorm_bwd(*ctx.saved_tensors, dy)
        return dx, dw, None


def rmsnorm(x, w, eps: float = 1e-5):
    """RMSNorm with f32 statistics and compute-dtype activations in both
    directions: a plain autograd rmsnorm would carry f32 (B, S, D)
    gradients into the residual stream through the f32 mean of squares."""
    return _RMSNorm.apply(x, w, eps)


def _rope_angles(positions, hd: int, theta: float):
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S).

    The sin/cos tables are f32 (small: no head dim); the rotation itself
    runs in the compute dtype, or in f32 under ``legacy_f32()``."""
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)     # (..., S, half) f32
    cos = cos[..., None, :]                            # broadcast over heads
    sin = sin[..., None, :]
    if legacy_f32():
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         dim=-1).to(x.dtype)
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# flash-style attention (an online softmax over KV blocks)
# ---------------------------------------------------------------------------

def _kv_blocks(k, v, block: int):
    """k/v (B, Skv, Hkv, hd) zero-padded to whole blocks of
    ``min(block, Skv)`` keys, as (B, nblk, blk, Hkv, hd)."""
    B, Skv, Hkv, hd = k.shape
    blk = min(block, Skv)
    nblk = (Skv + blk - 1) // blk
    pad = nblk * blk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    return (k.reshape(B, nblk, blk, Hkv, hd),
            v.reshape(B, nblk, blk, Hkv, hd), blk, nblk)


def _flash_scan(q, k, v, causal: bool, q_offset, kv_len, block: int):
    """Forward online-softmax scan. Returns (out, m, lse) with out already
    normalized; m/lse are the per-query statistics."""
    B, Sq, Hkv, G, hd = q.shape
    Skv = k.shape[1]
    kb, vb, blk, nblk = _kv_blocks(k, v, block)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    limit = Skv if kv_len is None else kv_len
    qf = q.float()

    kb, vb = kb.transpose(0, 1), vb.transpose(0, 1)

    def step(carry, inp):
        m, lse, acc = carry
        bi, kblk, vblk = inp
        k_pos = bi * blk + torch.arange(blk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk.float()) * scale
        mask = k_pos[None, :] < limit
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = lse * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vblk.dtype).float(),
                          vblk.float())
        acc_new = acc * corr[..., None] + pv
        return (m_new, l_new, acc_new), None

    f32 = dict(dtype=torch.float32, device=dev)
    m0 = torch.full((B, Hkv, G, Sq), -math.inf, **f32)
    l0 = torch.zeros((B, Hkv, G, Sq), **f32)
    a0 = torch.zeros((B, Hkv, G, Sq, hd), **f32)
    (m, lse, acc), _ = _act_scan(
        step, (m0, l0, a0), (torch.arange(nblk, device=dev), kb, vb))
    out = acc / torch.clamp(lse[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,Sq,Hkv,G,hd)
    return out, m, torch.clamp(lse, min=1e-30)


def _flash_bwd(q, k, v, out, m, lse, dout, causal: bool, q_offset: int,
               block: int):
    """Flash-attention backward: the scores recomputed one KV block at a
    time from the saved forward statistics, ``delta = sum(dout * out)``;
    dq accumulates in f32 across blocks, dk and dv come a block at a time
    in the compute dtype.  Products the reference takes with
    ``preferred_element_type=float32`` run on f32 upcasts; the others, and
    the elementwise chain of ``ds``, round to the compute dtype after each
    op."""
    B, Sq, Hkv, G, hd = q.shape
    Skv = k.shape[1]
    dt = q.dtype
    kb, vb, blk, nblk = _kv_blocks(k, v, block)
    scale = 1.0 / math.sqrt(hd)
    scale_dt = float(torch.tensor(scale, dtype=dt))   # q.dtype.type(scale)
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    qf = q.float()
    do = dout.permute(0, 2, 3, 1, 4).to(dt)            # (B,Hkv,G,Sq,hd)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dout.float(), out.float())
    delta_dt = delta[..., None].to(dt)
    dq = torch.zeros((B, Sq, Hkv, G, hd), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for bi in range(nblk):
        kblk, vblk = kb[:, bi], vb[:, bi]
        k_pos = bi * blk + torch.arange(blk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kblk.float()) * scale
        mask = k_pos[None, :] < Skv
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask, s, -math.inf)
        p = (torch.exp(s - m[..., None]) / lse[..., None]).to(dt)
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, do))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", do, vblk)
        ds = p * (dp - delta_dt) * scale_dt
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds.float(),
                               kblk.float())
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, q))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The flash scan of train and prefill (a static ``q_offset``, no
    ``kv_len``); its residuals are ``(q, k, v, out, m, lse)`` only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, block):
        out, m, lse = _flash_scan(q, k, v, causal, q_offset, None, block)
        ctx.save_for_backward(q, k, v, out, m, lse)
        ctx.meta = (causal, q_offset, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _flash_bwd(*ctx.saved_tensors, dout, *ctx.meta)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool, q_offset=0,
                    kv_len: Optional[int] = None,
                    block: int = DEFAULT_KV_BLOCK):
    """q: (B, Sq, Hkv, G, hd); k/v: (B, Skv, Hkv, hd).

    ``q_offset``: absolute position of q[0] (prefill continuation / decode).
    ``kv_len``: optional valid-KV length (decode against a cache).
    Train and prefill (an ``int`` offset, no ``kv_len``) take the flash
    Function and its backward; decode keeps the plain scan (no grads)."""
    if kv_len is None and isinstance(q_offset, int):
        return _FlashAttention.apply(q, k, v, causal, q_offset,
                                     min(block, k.shape[1]))
    out, _, _ = _flash_scan(q, k, v, causal, q_offset, kv_len, block)
    return out


# ---------------------------------------------------------------------------
# attention layers
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, Hkv, hd)
    v: torch.Tensor


def _pad_heads(t, target: int):
    """Pad the head dim (axis -2) of (B, S, h, hd) up to ``target`` heads."""
    if t.shape[-2] >= target:
        return t
    return F.pad(t, (0, 0, 0, target - t.shape[-2]))


def _project_qkv(p, cfg: ModelConfig, x, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, cast(p["wq"], dt))
    k = torch.einsum("bsd,dhe->bshe", x, cast(p["wk"], dt))
    v = torch.einsum("bsd,dhe->bshe", x, cast(p["wv"], dt))
    q = constrain(q, ("batch", None, "model", None))
    k = constrain(k, ("batch", None, "model", None))
    v = constrain(v, ("batch", None, "model", None))
    if cfg.qkv_bias:
        q = q + cast(p["bq"], dt)
        k = k + cast(p["bk"], dt)
        v = v + cast(p["bv"], dt)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:  # rope (None for whisper-style abs-pos models)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p, cfg: ModelConfig, x, *, positions, causal: bool = True,
              q_offset=0, kv_override=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    Returns (out, (k, v)) -- k/v for cache capture during prefill.
    ``kv_override``: (k, v) for cross-attention (keys from the encoder).
    """
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv
    if kv_override is None:
        q, k, v = _project_qkv(p, cfg, x, positions)
    else:
        dt = x.dtype
        q = torch.einsum("bsd,dhe->bshe", x, cast(p["wq"], dt))
        if cfg.qkv_bias:
            q = q + cast(p["bq"], dt)
        k, v = kv_override
    B, S = x.shape[:2]
    qg = q.reshape(B, S, Hkv, G, hd)
    out = flash_attention(qg, k, v, causal=causal, q_offset=q_offset)
    out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshe,hed->bsd", out, cast(p["wo"], x.dtype))
    # the cache copy is padded to kv_cache_heads so it can shard evenly
    kvc = cfg.kv_cache_heads
    return y, (_pad_heads(k, kvc), _pad_heads(v, kvc))


def _update_at(cache, new, pos: int):
    """``cache`` with ``new`` written at sequence position ``pos`` (axis 1),
    the start clamped so the update fits, as ``dynamic_update_slice``
    does; ``cache`` itself is left as it was."""
    start = min(max(pos, 0), cache.shape[1] - new.shape[1])
    out = cache.clone()
    out[:, start:start + new.shape[1]] = new.to(cache.dtype)
    return out


def decode_attention(p, cfg: ModelConfig, x, cache: KVCache, pos):
    """Single-token decode against a KV cache. x: (B, 1, D); pos: int.

    Supports KV caches whose head dim is padded to ``cfg.kv_cache_heads``:
    padded q rows are zero and their outputs are sliced away."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    G = H // Hkv
    B = x.shape[0]
    kvc = cache.k.shape[-2]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    k = _update_at(cache.k, _pad_heads(k_new, kvc), pos)
    v = _update_at(cache.v, _pad_heads(v_new, kvc), pos)
    qg = q.reshape(B, 1, Hkv, G, hd)
    if kvc > Hkv:
        qg = F.pad(qg, (0, 0, 0, 0, 0, kvc - Hkv))
    out = flash_attention(qg, k, v, causal=False, kv_len=pos + 1)
    out = out[:, :, :Hkv].reshape(B, 1, H, hd)
    y = torch.einsum("bshe,hed->bsd", out, cast(p["wo"], x.dtype))
    return y, KVCache(k, v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(p, x):
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", x, cast(p["w_gate"], dt))
    u = torch.einsum("bsd,df->bsf", x, cast(p["w_up"], dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, cast(p["w_down"], dt))


def gelu_mlp(p, x):
    dt = x.dtype
    h = F.gelu(torch.einsum("bsd,df->bsf", x, cast(p["w_in"], dt)) +
               cast(p["b_in"], dt), approximate="tanh")
    return (torch.einsum("bsf,fd->bsd", h, cast(p["w_out"], dt)) +
            cast(p["b_out"], dt))


# ---------------------------------------------------------------------------
# decoder blocks
# ---------------------------------------------------------------------------

def dense_block(p, cfg: ModelConfig, x, *, positions, causal=True,
                q_offset=0):
    x = constrain(x, ("batch", None, None))  # pin loop-carry sharding
    h, kv = attention(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                      positions=positions, causal=causal, q_offset=q_offset)
    x = x + h
    x = x + swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def dense_block_decode(p, cfg: ModelConfig, x, cache: KVCache, pos):
    h, cache = decode_attention(p["attn"], cfg,
                                rmsnorm(x, p["ln1"], cfg.norm_eps), cache, pos)
    x = x + h
    x = x + swiglu(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps))
    return x, cache
