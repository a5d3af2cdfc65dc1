"""Configuration and run logging (counterpart of ``utils/``)."""

from .config import MeshConfig, StftConfig, UPitTrainConfig, load_config, save_config
from .profiling import MetricsLogger

__all__ = [
    "MeshConfig",
    "MetricsLogger",
    "StftConfig",
    "UPitTrainConfig",
    "load_config",
    "save_config",
]
