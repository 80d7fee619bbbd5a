"""Architecture registry: the 10 assigned configs + reduced smoke variants."""

from .base import ARCH_IDS, SHAPES, ModelConfig, ShapeConfig, get_config, list_configs

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "list_configs"]
