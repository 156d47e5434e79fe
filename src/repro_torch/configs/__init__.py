"""The model configurations of the port (copies of ``repro/configs``):
``get_config(name)``, ``ARCHS``, ``SHAPES``, ``smoke_variant``."""
from .registry import get_config, list_archs, ARCHS        # noqa: F401
from .base import SHAPES, ShapeConfig, ModelConfig, shape_applicable, smoke_variant  # noqa: F401
