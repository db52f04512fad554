"""mamba2-130m [ssm]: 24L d=768 (attention-free) vocab=50280 ssm_state=128,
SSD (state-space duality)  [arXiv:2405.21060]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_kernel=4,
    ssm_chunk=128, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, conv_kernel=4,
    ssm_chunk=8, tie_embeddings=True,
    remat=False, dtype="float32",
)
