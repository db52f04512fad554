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

from .act import constrain
from .act import einsum as _einsum
from .act import (from_local, fsdp_placements, gather_fsdp, grad_summed,
                  is_dtensor, legacy_f32, local_param, local_shard,
                  row_placements)
from .act import scan as _act_scan
from .config import ModelConfig

__all__ = [
    "rmsnorm", "rope", "flash_attention", "attention", "decode_attention",
    "swiglu", "gelu_mlp", "dense_block", "dense_block_decode", "KVCache",
]

DEFAULT_KV_BLOCK = 1024


def cast(x, dtype):
    """A parameter in ``dtype``; under an activation mesh, gathered over
    the batch (FSDP) axes first (``act.gather_fsdp``)."""
    x = gather_fsdp(x)
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
    """Pad the head dim (axis -2) of (B, S, h, hd) up to ``target`` heads
    (a DTensor is padded whole over "model", its batch sharding kept)."""
    if t.shape[-2] >= target:
        return t
    if is_dtensor(t):
        pl = row_placements(t.shape[0], None)
        local = _pad_heads(t.redistribute(t.device_mesh, pl).to_local(),
                           target)
        return from_local(local, t.device_mesh, pl,
                          t.shape[:-2] + (target, t.shape[-1]))
    return F.pad(t, (0, 0, 0, target - t.shape[-2]))


# ---------------------------------------------------------------------------
# attention on local shards (under an activation mesh)
# ---------------------------------------------------------------------------

def embed(table, ids):
    """``table[ids]``.  A DTensor table (vocab rows over "model", FSDP over
    the batch axes) is read on local shards: the rows gathered over the
    batch axes, each model rank looks up the ids in its vocab slice (zero
    elsewhere) for its batch rows, and the result is a partial sum over
    "model"."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    model = tuple(mesh.mesh_dim_names).index("model")
    if is_dtensor(ids):
        rows = row_placements(ids.shape[0], None)
        ids_l = local_shard(ids, rows)
    else:                     # the same ids on every rank
        rows, ids_l = (Replicate(),) * mesh.ndim, ids
    tpl = fsdp_placements(table)
    w = local_param(table, tpl, rows)
    out = list(rows)
    if tpl[model] == Shard(0):
        n = w.shape[0]
        lo = mesh.get_local_rank(model) * n
        hit = (ids_l >= lo) & (ids_l < lo + n)
        x = w[torch.where(hit, ids_l - lo, 0)] * hit[..., None].to(w.dtype)
        out[model] = Partial()
    else:
        x = w[ids_l]
    return from_local(x, mesh, out, tuple(ids.shape) + (table.shape[1],))


def attend(q, k, v, n_kv: int, *, causal: bool, q_offset=0):
    """Train/prefill attention core: q (B, Sq, H, hd), k/v (B, Skv, n_kv,
    hd) -> (B, Sq, H, hd).  DTensors run the flash scan on their local
    shards, as the reference's does per device: batch rows over the batch
    axes and KV heads (with their query groups) over "model" where the
    model axis divides ``n_kv``; where it divides only the query heads
    (qwen3-1.7b: 16 query and 8 KV heads over 16), the query heads, each
    rank reading the KV heads its own use; else the KV heads split
    unevenly (``_attend_uneven``)."""
    B, Sq, H, hd = q.shape
    if not is_dtensor(q):
        qg = q.reshape(B, Sq, n_kv, H // n_kv, hd)
        out = flash_attention(qg, k, v, causal=causal, q_offset=q_offset)
        return out.reshape(B, Sq, H, hd)
    mesh = q.device_mesh
    model = tuple(mesh.mesh_dim_names).index("model")
    n, G = mesh.size(model), H // n_kv
    h_l = H // n
    if n_kv % n and not H % n and (h_l % G == 0 or G % h_l == 0):
        # query heads over "model", the KV heads whole: each rank reads
        # the KV heads its query heads use, and its gradient of them is
        # a partial sum over "model"
        from torch.distributed.tensor import Partial

        pl_q, pl_kv = row_placements(B, H), row_placements(B, None)
        grad = [Partial() if i == model else p for i, p in enumerate(pl_kv)]
        r = mesh.get_local_rank(model)
        heads = slice(r * h_l // G, ((r + 1) * h_l - 1) // G + 1)
        kl, vl = (t.redistribute(mesh, pl_kv).to_local(
            grad_placements=grad)[:, :, heads] for t in (k, v))
        out = attend(local_shard(q, pl_q), kl, vl, kl.shape[2],
                     causal=causal, q_offset=q_offset)
        return from_local(out, mesh, pl_q, q.shape)
    if n_kv % n == 0:
        pl = row_placements(B, n_kv)
        kl = local_shard(k, pl)
        out = attend(local_shard(q, pl), kl, local_shard(v, pl), kl.shape[2],
                     causal=causal, q_offset=q_offset)
        return from_local(out, mesh, pl, q.shape)
    return _attend_uneven(q, k, v, n_kv, mesh, model, causal=causal,
                          q_offset=q_offset)


def _attend_uneven(q, k, v, n_kv: int, mesh, model: int, *, causal: bool,
                   q_offset):
    """``attend`` where the model axis of n ranks divides neither the KV
    nor the query heads (whisper's 8 over 16, granite-moe's 24 / 8,
    qwen1.5-32b's 40): the KV heads split as ``torch.chunk`` splits them,
    ceil(n_kv / n) a rank with their query groups and the last ranks
    short or empty, where GSPMD pads every rank to that count.  The
    outputs are all-gathered over "model"; each rank's gradient of q, k
    and v covers its own heads and is summed there."""
    from torch.distributed.tensor import Shard

    B, Sq, H, hd = q.shape
    G = H // n_kv
    rows = row_placements(B)
    kp = -(-n_kv // mesh.size(model))
    r = mesh.get_local_rank(model)
    heads = slice(min(r * kp, n_kv), min((r + 1) * kp, n_kv))
    ql, kl, vl = (grad_summed(local_shard(t, rows), mesh, rows, model)
                  for t in (q, k, v))
    qg = ql.reshape(ql.shape[0], Sq, n_kv, G, hd)[:, :, heads]
    out = flash_attention(qg, kl[:, :, heads], vl[:, :, heads],
                          causal=causal, q_offset=q_offset)
    split = tuple(Shard(2) if i == model else p for i, p in enumerate(rows))
    out = local_shard(from_local(out, mesh, split, (B, Sq, n_kv, G, hd)),
                      rows)
    return from_local(out.reshape(out.shape[0], Sq, H, hd), mesh, rows,
                      q.shape)


def _decode_core(q, k_new, v_new, ck, cv, pos: int, n_kv: int):
    """Plain decode attention: the cache (B, Smax, kvc, hd) with the new
    token's k/v (heads padded to kvc) written at ``pos``; q (B, 1, H, hd)
    padded with zero groups to kvc KV heads; returns (out (B, 1, H, hd),
    k, v)."""
    B, _, H, hd = q.shape
    G = H // n_kv
    kvc = ck.shape[-2]
    k = _update_at(ck, _pad_heads(k_new, kvc), pos)
    v = _update_at(cv, _pad_heads(v_new, kvc), pos)
    qg = q.reshape(B, 1, n_kv, G, hd)
    if kvc > n_kv:
        qg = F.pad(qg, (0, 0, 0, 0, 0, kvc - n_kv))
    out = flash_attention(qg, k, v, causal=False, kv_len=pos + 1)
    return out[:, :, :n_kv].reshape(B, 1, H, hd), k, v


def attend_decode(q, k_new, v_new, ck, cv, pos: int, n_kv: int):
    """One decode step's attention against a KV cache (see
    ``_decode_core``).  A DTensor cache keeps its sharding: batch rows over
    the batch axes, and its (padded) KV heads over "model" where the cache
    is sharded so; the step's q/k/v (one token) are gathered whole over
    "model", each rank attends with its own KV heads' groups, and the
    heads' outputs are gathered back."""
    if not is_dtensor(q):
        return _decode_core(q, k_new, v_new, ck, cv, pos, n_kv)
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    B, _, H, hd = q.shape
    G, kvc = H // n_kv, ck.shape[-2]
    pl_c = tuple(ck.placements)
    model = tuple(mesh.mesh_dim_names).index("model")
    pl_r = tuple(Replicate() if isinstance(p, Shard) and p.dim == 2 else p
                 for p in pl_c)
    ql, kn, vn = (local_shard(t, pl_r) for t in (q, k_new, v_new))
    ckl, cvl = local_shard(ck, pl_c), local_shard(cv, pl_c)
    if pl_c[model] == Shard(2):
        # this rank's KV heads [r*kl, (r+1)*kl) of the padded kvc
        r, kl = mesh.get_local_rank(model), kvc // mesh.size(model)
        heads = slice(r * kl, (r + 1) * kl)
        k = _update_at(ckl, _pad_heads(kn, kvc)[:, :, heads], pos)
        v = _update_at(cvl, _pad_heads(vn, kvc)[:, :, heads], pos)
        qg = ql.reshape(ql.shape[0], 1, n_kv, G, hd)
        qg = F.pad(qg, (0, 0, 0, 0, 0, kvc - n_kv))[:, :, heads]
        out = flash_attention(qg, k, v, causal=False, kv_len=pos + 1)
        out = local_shard(from_local(out, mesh, pl_c, (B, 1, kvc, G, hd)),
                          pl_r)
        out = out[:, :, :n_kv].reshape(ql.shape[0], 1, H, hd)
    else:
        out, k, v = _decode_core(ql, kn, vn, ckl, cvl, pos, n_kv)
    return (from_local(out, mesh, pl_r, q.shape),
            from_local(k, mesh, pl_c, ck.shape),
            from_local(v, mesh, pl_c, cv.shape))


def _project_qkv(p, cfg: ModelConfig, x, positions):
    dt = x.dtype
    q = _einsum("bsd,dhe->bshe", x, cast(p["wq"], dt))
    k = _einsum("bsd,dhe->bshe", x, cast(p["wk"], dt))
    v = _einsum("bsd,dhe->bshe", x, cast(p["wv"], dt))
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
        q = _einsum("bsd,dhe->bshe", x, cast(p["wq"], dt))
        if cfg.qkv_bias:
            q = q + cast(p["bq"], dt)
        k, v = kv_override
    out = attend(q, k, v, Hkv, causal=causal, q_offset=q_offset)
    y = _einsum("bshe,hed->bsd", out, cast(p["wo"], x.dtype))
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
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, x, positions)
    out, k, v = attend_decode(q, k_new, v_new, cache.k, cache.v, pos,
                              cfg.n_kv_heads)
    y = _einsum("bshe,hed->bsd", out, cast(p["wo"], x.dtype))
    return y, KVCache(k, v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def swiglu(p, x):
    dt = x.dtype
    g = _einsum("bsd,df->bsf", x, cast(p["w_gate"], dt))
    u = _einsum("bsd,df->bsf", x, cast(p["w_up"], dt))
    return _einsum("bsf,fd->bsd", F.silu(g) * u, cast(p["w_down"], dt))


def gelu_mlp(p, x):
    dt = x.dtype
    h = F.gelu(_einsum("bsd,df->bsf", x, cast(p["w_in"], dt)) +
               cast(p["b_in"], dt), approximate="tanh")
    return (_einsum("bsf,fd->bsd", h, cast(p["w_out"], dt)) +
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
