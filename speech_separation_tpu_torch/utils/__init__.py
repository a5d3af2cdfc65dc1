"""Configuration, run logging and profiler spans (counterpart of ``utils/``)."""

from .config import (
    MeshConfig,
    StftConfig,
    UPitTrainConfig,
    VaeTrainConfig,
    load_config,
    save_config,
)
from .profiling import MetricsLogger, span

__all__ = [
    "MeshConfig",
    "MetricsLogger",
    "StftConfig",
    "UPitTrainConfig",
    "VaeTrainConfig",
    "load_config",
    "save_config",
    "span",
]
