from .base import ARCH_NAMES, cells, get_config, shape_applicable

__all__ = ["ARCH_NAMES", "get_config", "cells", "shape_applicable"]
