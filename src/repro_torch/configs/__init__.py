"""Model configurations of the port (copies of ``repro.configs``)."""
from .base import (ALL_SHAPES, ModelConfig, ShapeConfig, cell_is_applicable,
                   shape_by_name)
from .registry import all_configs, get_config, get_smoke_config, list_archs
