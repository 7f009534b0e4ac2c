"""Model configurations (a copy of ``repro.configs``: all eleven archs)."""
from .base import ARCH_IDS, ModelConfig, get_config

__all__ = ["ARCH_IDS", "ModelConfig", "get_config"]
