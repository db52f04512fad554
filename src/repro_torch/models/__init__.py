"""Model zoo of the port: the dense and VLM backbones (the MoE, SSM,
hybrid and encoder-decoder families are ROADMAP A.11.2b)."""
from .config import SHAPES, ModelConfig, Shape
from .registry import MODEL_FAMILIES, get_model

__all__ = ["ModelConfig", "Shape", "SHAPES", "get_model", "MODEL_FAMILIES"]
