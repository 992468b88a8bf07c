"""Configurations of the port: the LM architectures (``ModelConfig``, one
module per architecture with ``CONFIG`` and ``SMOKE``, resolved by
``registry``) and the UDG serving deployment (``udg_serve``)."""
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    dtype_of,
    shape_supported,
)
from repro_torch.configs.registry import ARCH_NAMES, all_configs, get_config
from repro_torch.configs.udg_serve import CONFIG, UdgServeConfig

__all__ = [
    "ARCH_NAMES",
    "CONFIG",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "UdgServeConfig",
    "all_configs",
    "dtype_of",
    "get_config",
    "shape_supported",
]
