"""pixtral-12b [vlm]: 40L d=5120 32H (GQA kv=8) d_ff=14336 vocab=131072,
pixtral-ViT frontend stubbed (precomputed patch embeddings) + mistral-nemo
decoder  [hf:mistralai/Pixtral-12B-2409]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1e6,
    n_patches=1024,
)

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, head_dim=16, n_patches=8,
    remat=False, dtype="float32",
)
