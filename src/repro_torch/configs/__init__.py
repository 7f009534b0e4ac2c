"""Model configurations (a copy of ``repro.configs``: all eleven archs, and
the port's own, ``PORT_ARCH_IDS``) and the dry runs' input shapes."""
from .base import (ARCH_IDS, INPUT_SHAPES, PORT_ARCH_IDS, ModelConfig, ShapeConfig,
                   get_config)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "PORT_ARCH_IDS", "ModelConfig", "ShapeConfig",
           "get_config"]
