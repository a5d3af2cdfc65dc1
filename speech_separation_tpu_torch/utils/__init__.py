"""Configuration and run logging (counterpart of ``utils/``)."""

from .config import (
    MeshConfig,
    StftConfig,
    UPitTrainConfig,
    VaeTrainConfig,
    load_config,
    save_config,
)
from .profiling import MetricsLogger

__all__ = [
    "MeshConfig",
    "MetricsLogger",
    "StftConfig",
    "UPitTrainConfig",
    "VaeTrainConfig",
    "load_config",
    "save_config",
]
