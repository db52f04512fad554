"""Model zoo of the port: the dense and VLM backbones, MoE, Mamba2 (SSD),
the Zamba2-style hybrid and the whisper-style encoder-decoder, each
family built by ``get_model``."""
from .config import SHAPES, ModelConfig, Shape
from .registry import MODEL_FAMILIES, get_model

__all__ = ["ModelConfig", "Shape", "SHAPES", "get_model", "MODEL_FAMILIES"]
