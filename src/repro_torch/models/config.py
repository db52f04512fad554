"""Model and shape configuration dataclasses.

Counterpart of ``repro/models/config.py``, copied: the same fields,
defaults and properties, so a config names the same model in both
packages."""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "Shape", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 0
    head_dim: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_shard_dim: str = "expert"     # "expert" (EP) or "mlp" (TP-in-expert)
    n_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_kernel: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2)
    attn_every: int = 0               # shared attention block period
    n_shared_blocks: int = 1          # alternating shared blocks
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_seq: int = 0                  # precomputed frame-embedding count
    # vlm (pixtral)
    n_patches: int = 0                # precomputed patch-embedding count
    # serving
    kv_cache_pad_heads: int = 0   # pad cached KV heads to a multiple of this
                                  # (0 = off) so the cache can shard over the
                                  # model axis when n_kv_heads doesn't divide
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    remat: bool = True

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def kv_cache_heads(self) -> int:
        """Cached KV head count (>= n_kv_heads; padded when configured)."""
        p = self.kv_cache_pad_heads
        if p <= 0:
            return self.n_kv_heads
        return ((self.n_kv_heads + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has a decode path (whisper is enc-dec)


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}
