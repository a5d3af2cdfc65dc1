"""DSP ops and the CUDA kernels' wrappers."""

from .dispatch import plain_versions, use_plain

__all__ = ["plain_versions", "use_plain"]
