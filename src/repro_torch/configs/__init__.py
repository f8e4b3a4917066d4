"""Configs of every architecture of the reference's zoo."""

from .archs import ALL_ARCHS
from .base import (
    SHAPES,
    ModelConfig,
    NotPortedError,
    ShapeConfig,
    get_config,
    list_configs,
    register,
    runnable_shapes,
)
from .zamba2_7b import ZAMBA2_7B

__all__ = [
    "ALL_ARCHS",
    "SHAPES",
    "ZAMBA2_7B",
    "ModelConfig",
    "NotPortedError",
    "ShapeConfig",
    "get_config",
    "list_configs",
    "register",
    "runnable_shapes",
]
