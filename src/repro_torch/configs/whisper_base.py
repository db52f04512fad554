"""whisper-base [audio]: 6L(enc)+6L(dec) d=512 8H d_ff=2048 vocab=51865,
enc-dec with stubbed conv frontend (precomputed frame embeddings)
[arXiv:2212.04356]."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, enc_seq=1500, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_seq=32, tie_embeddings=True,
    remat=False, dtype="float32",
)
