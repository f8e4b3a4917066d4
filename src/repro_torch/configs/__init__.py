"""Configs of the architectures the port runs (zamba2-7b so far)."""

from .base import (
    SHAPES,
    ModelConfig,
    NotPortedError,
    ShapeConfig,
    get_config,
    list_configs,
    register,
)
from .zamba2_7b import ZAMBA2_7B

__all__ = [
    "SHAPES",
    "ZAMBA2_7B",
    "ModelConfig",
    "NotPortedError",
    "ShapeConfig",
    "get_config",
    "list_configs",
    "register",
]
