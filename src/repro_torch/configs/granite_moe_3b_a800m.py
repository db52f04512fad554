"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8  [hf:ibm-granite].  40 experts do not divide the
16-way model axis, so EP shards the in-expert mlp dim instead (512/16=32)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, experts_per_token=8, moe_shard_dim="mlp",
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab=128,
    n_experts=5, experts_per_token=2, moe_shard_dim="mlp",
    moe_capacity_factor=8.0,
    remat=False, dtype="float32",
)
