"""Model configurations (a copy of ``repro.configs``: all eleven archs) and
the dry runs' input shapes."""
from .base import ARCH_IDS, INPUT_SHAPES, ModelConfig, ShapeConfig, get_config

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "ModelConfig", "ShapeConfig", "get_config"]
