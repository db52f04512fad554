"""granite-8b [dense]: 36L d=4096 32H (GQA kv=8) d_ff=14336 vocab=49152,
llama-arch code model  [arXiv:2405.04324]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=49152, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256,
    remat=False, dtype="float32",
)
