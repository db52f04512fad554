"""zamba2-2.7b [hybrid]: 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000
ssm_state=64 — Mamba2 backbone + 2 alternating shared attention blocks every
6 layers  [arXiv:2411.15242]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    ssm_chunk=128, attn_every=6, n_shared_blocks=2,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_kernel=4,
    ssm_chunk=8, attn_every=2, n_shared_blocks=2,
    remat=False, dtype="float32",
)
