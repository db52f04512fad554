"""Family registry: config -> model instance.

Counterpart of ``repro/models/registry.py``: every family is ported."""
from __future__ import annotations

from .config import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def get_model(cfg: ModelConfig, device=None):
    """The model of ``cfg``'s family on ``device`` (default ``"cuda"``)."""
    from .encdec import EncDecModel
    from .hybrid import HybridModel
    from .mamba2 import MambaModel
    from .moe import MoEModel
    from .transformer import DenseModel

    fam = {
        "dense": DenseModel,
        "vlm": DenseModel,
        "moe": MoEModel,
        "ssm": MambaModel,
        "hybrid": HybridModel,
        "encdec": EncDecModel,
    }
    if cfg.family not in fam:
        raise KeyError(f"unknown family {cfg.family}")
    return fam[cfg.family](cfg, device)
