"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (GQA kv=16) d_ff=1408
vocab=163840, MoE 64e top-6  [hf:moonshotai/Moonlight-16B-A3B]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=163840,
    n_experts=64, experts_per_token=6, moe_shard_dim="expert",
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=256,
    n_experts=4, experts_per_token=2, moe_shard_dim="expert",
    moe_capacity_factor=8.0,
    remat=False, dtype="float32",
)
