"""Assigned-architecture configs (exact published settings) + smoke
variants: the port's own copy of ``repro/configs``, data only."""
from .base import (
    ArchConfig, get_config, get_smoke, list_archs, register, SHAPES, shape_for,
)

__all__ = ["ArchConfig", "get_config", "get_smoke", "list_archs", "register",
           "SHAPES", "shape_for"]
