"""DSP ops and the CUDA kernels' wrappers."""

from .dispatch import fixed_shape_calls, plain_versions, use_plain

__all__ = ["fixed_shape_calls", "plain_versions", "use_plain"]
