"""Whisper-style encoder-decoder backbone.

Counterpart of ``repro/models/encdec.py``, eager.  The
conv/mel frontend is a stub: ``input_specs`` asks for precomputed frame
embeddings (B, enc_seq, d_model).  Both stacks add sinusoidal positions
computed on the fly (decode at an offset), so the params do not depend on
the sequence length.

Blocks follow whisper: pre-LayerNorm (with bias, f32 statistics), biased
q/v/o projections, GELU MLP; the decoder adds cross-attention over the
encoder's output, whose KV is computed once at prefill and cached.
Logits are tied to the token embedding.
"""
from __future__ import annotations

import math

import torch

from .act import constrain, gather_fsdp, remat
from .act import einsum as _einsum
from .act import scan as _act_scan
from .config import ModelConfig, Shape
from .layers import attend, attend_decode, cast, embed, gelu_mlp
from .params import PS, P
from .transformer import DenseModel, TensorSpec, cross_entropy, stack_layers

__all__ = ["EncDecModel", "layernorm", "sinusoid_positions"]


def layernorm(x, p, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * cast(p["w"], x.dtype) + cast(p["b"], x.dtype)


def _ln_table(D):
    return {"w": P((D,), (None,), "ones"), "b": P((D,), (None,), "zeros")}


def _attn_table(cfg: ModelConfig):
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": P((D, H, hd), ("embed", "heads", None)),
        "wk": P((D, H, hd), ("embed", "heads", None)),
        "wv": P((D, H, hd), ("embed", "heads", None)),
        "wo": P((H, hd, D), ("heads", None, "embed")),
        "bq": P((H, hd), ("heads", None), "zeros"),
        "bv": P((H, hd), ("heads", None), "zeros"),
        "bo": P((D,), (None,), "zeros"),
    }


def _mlp_table(cfg: ModelConfig):
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "w_in": P((D, F_), ("embed", "mlp")),
        "b_in": P((F_,), ("mlp",), "zeros"),
        "w_out": P((F_, D), ("mlp", "embed")),
        "b_out": P((D,), (None,), "zeros"),
    }


def sinusoid_positions(S, D, offset=0, device=None):
    """(S, D) f32: sin | cos of positions ``offset .. offset + S - 1``."""
    pos = offset + torch.arange(S, dtype=torch.float32, device=device)
    half = D // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / half)
    ang = pos[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _project_q(p, x):
    return _einsum("bsd,dhe->bshe", x, cast(p["wq"], x.dtype)) + \
        cast(p["bq"], x.dtype)


def _project_kv(p, x):
    dt = x.dtype
    k = _einsum("bsd,dhe->bshe", x, cast(p["wk"], dt))
    v = _einsum("bsd,dhe->bshe", x, cast(p["wv"], dt)) + cast(p["bv"], dt)
    return k, v


def _mha(p, cfg, xq, xkv=None, *, causal, q_offset=0, kv_override=None):
    """Whisper-flavoured MHA (no rope, biased q/v/o projections)."""
    q = _project_q(p, xq)
    if kv_override is not None:
        k, v = kv_override
    else:
        k, v = _project_kv(p, xq if xkv is None else xkv)
    out = attend(q, k, v, cfg.n_heads, causal=causal, q_offset=q_offset)
    y = _einsum("bshe,hed->bsd", out, cast(p["wo"], out.dtype)) + \
        cast(p["bo"], out.dtype)
    return y, (k, v)


class EncDecModel(DenseModel):
    family = "encdec"

    def table(self) -> dict:
        cfg = self.cfg
        enc_block = {
            "attn": _attn_table(cfg), "mlp": _mlp_table(cfg),
            "ln1": _ln_table(cfg.d_model), "ln2": _ln_table(cfg.d_model),
        }
        dec_block = {
            "attn": _attn_table(cfg), "xattn": _attn_table(cfg),
            "mlp": _mlp_table(cfg),
            "ln1": _ln_table(cfg.d_model), "lnx": _ln_table(cfg.d_model),
            "ln2": _ln_table(cfg.d_model),
        }
        return {
            "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                       scale=0.02),
            "enc_layers": stack_layers(enc_block, cfg.n_enc_layers),
            "dec_layers": stack_layers(dec_block, cfg.n_layers),
            "enc_ln_f": _ln_table(cfg.d_model),
            "dec_ln_f": _ln_table(cfg.d_model),
        }

    # ------------------------------------------------------------------
    def _positions(self, S, offset=0):
        return sinusoid_positions(S, self.cfg.d_model, offset, self.device)

    def encode(self, params, frames):
        cfg = self.cfg
        x = self._input(frames, self.adtype)
        x = x + self._positions(x.shape[1]).to(x.dtype)

        def body(x, p):
            x = constrain(x, ("batch", None, None))  # pin carry sharding
            h, _ = _mha(p["attn"], cfg, layernorm(x, p["ln1"], cfg.norm_eps),
                        causal=False)
            x = x + h
            x = x + gelu_mlp(p["mlp"], layernorm(x, p["ln2"], cfg.norm_eps))
            return x, None

        if cfg.remat:
            body = remat(body)
        x, _ = _act_scan(body, x, params["enc_layers"])
        return layernorm(x, params["enc_ln_f"], cfg.norm_eps)

    def _decode_stack(self, params, x, enc_out, *, q_offset=0,
                      collect_cache=False):
        cfg = self.cfg

        def body(x, p):
            x = constrain(x, ("batch", None, None))  # pin carry sharding
            h, kv = _mha(p["attn"], cfg,
                         layernorm(x, p["ln1"], cfg.norm_eps),
                         causal=True, q_offset=q_offset)
            x = x + h
            h, xkv = _mha(p["xattn"], cfg,
                          layernorm(x, p["lnx"], cfg.norm_eps), enc_out,
                          causal=False)
            x = x + h
            x = x + gelu_mlp(p["mlp"], layernorm(x, p["ln2"], cfg.norm_eps))
            return x, ((kv, xkv) if collect_cache else None)

        if cfg.remat:
            body = remat(body)
        x, caches = _act_scan(body, x, params["dec_layers"])
        return layernorm(x, params["dec_ln_f"], cfg.norm_eps), caches

    def _embed_tokens(self, params, tokens, offset=0):
        # gather, then cast: the reference's cast-then-gather, same values
        x = embed(params["embed"], self._input(tokens).long())
        x = x.to(self.adtype)
        return x + self._positions(x.shape[1], offset).to(x.dtype)

    def _tied_logits(self, params, x):
        return _einsum("bsd,vd->bsv", x,
                       gather_fsdp(params["embed"]).to(self.adtype))

    def loss(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_tokens(params, batch["tokens"])
        x, _ = self._decode_stack(params, x, enc_out)
        return cross_entropy(self._tied_logits(params, x),
                             self._input(batch["labels"]))

    def prefill(self, params, batch):
        enc_out = self.encode(params, batch["frames"])
        x = self._embed_tokens(params, batch["tokens"])
        x, caches = self._decode_stack(params, x, enc_out,
                                       collect_cache=True)
        (k, v), (xk, xv) = caches
        return self._tied_logits(params, x[:, -1:]), {"k": k, "v": v,
                                                      "xk": xk, "xv": xv}

    def decode(self, params, cache, batch):
        cfg = self.cfg
        pos = int(batch["pos"])
        x = self._embed_tokens(params, batch["token"], offset=pos)

        def body(x, inp):
            p, ck, cv, xk, xv = inp
            h = layernorm(x, p["ln1"], cfg.norm_eps)
            q = _project_q(p["attn"], h)
            k_new, v_new = _project_kv(p["attn"], h)
            o, ck, cv = attend_decode(q, k_new, v_new, ck, cv, pos,
                                      cfg.n_heads)
            x = x + _einsum("bshe,hed->bsd", o,
                            cast(p["attn"]["wo"], o.dtype)) + \
                cast(p["attn"]["bo"], o.dtype)
            h, _ = _mha(p["xattn"], cfg, layernorm(x, p["lnx"], cfg.norm_eps),
                        causal=False, kv_override=(xk, xv))
            x = x + h
            x = x + gelu_mlp(p["mlp"], layernorm(x, p["ln2"], cfg.norm_eps))
            return x, (ck, cv)

        x, (k2, v2) = _act_scan(
            body, x, (params["dec_layers"], cache["k"], cache["v"],
                      cache["xk"], cache["xv"]))
        x = layernorm(x, params["dec_ln_f"], cfg.norm_eps)
        return self._tied_logits(params, x), {"k": k2, "v": v2,
                                              "xk": cache["xk"],
                                              "xv": cache["xv"]}

    # ------------------------------------------------------------------
    def input_specs(self, shape: Shape) -> dict:
        cfg = self.cfg
        B, S = shape.batch, shape.seq
        i32 = torch.int32
        frames = TensorSpec((B, cfg.enc_seq, cfg.d_model), self.adtype)
        if shape.kind == "train":
            return {"frames": frames, "tokens": TensorSpec((B, S), i32),
                    "labels": TensorSpec((B, S), i32)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": TensorSpec((B, S), i32)}
        return {"token": TensorSpec((B, 1), i32), "pos": TensorSpec((), i32)}

    def cache_specs(self, shape: Shape) -> dict:
        cfg = self.cfg
        L, B = cfg.n_layers, shape.batch
        kv = TensorSpec((L, B, shape.seq, cfg.n_heads, cfg.hd), self.adtype)
        x = TensorSpec((L, B, cfg.enc_seq, cfg.n_heads, cfg.hd), self.adtype)
        return {"k": kv, "v": kv, "xk": x, "xv": x}

    def cache_pspecs(self, shape: Shape, batch_axes, kv_axes):
        ps = PS(None, batch_axes, None, kv_axes, None)
        return {"k": ps, "v": ps, "xk": ps, "xv": ps}
