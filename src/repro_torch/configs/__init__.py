"""Model configurations of the port (copies of ``repro.configs``)."""
from .base import ModelConfig, PORTED, require_ported
from .registry import get_config, get_smoke_config, list_archs
