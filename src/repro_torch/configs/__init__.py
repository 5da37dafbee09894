"""Architecture registry of the port's LM scaffold: ``get_config(arch)``
and the assigned shapes."""

from .registry import ARCHS, PORTED, SHAPES, ShapeSpec, get_config

__all__ = ["ARCHS", "PORTED", "SHAPES", "ShapeSpec", "get_config"]
