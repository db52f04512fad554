"""Family registry: config -> model instance.

Counterpart of ``repro/models/registry.py``.  The dense family and the
VLM variant are ported; the MoE, SSM, hybrid and encoder-decoder families
are ROADMAP A.11.2b and raise until they land."""
from __future__ import annotations

from .config import ModelConfig

MODEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")

_NOT_PORTED = ("moe", "ssm", "hybrid", "encdec")


def get_model(cfg: ModelConfig, device=None):
    """The model of ``cfg``'s family on ``device`` (default ``"cuda"``)."""
    from .transformer import DenseModel

    if cfg.family in ("dense", "vlm"):
        return DenseModel(cfg, device)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
            f"ROADMAP A.11.2b")
    raise KeyError(f"unknown family {cfg.family}")
