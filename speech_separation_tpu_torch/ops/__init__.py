"""DSP ops and the CUDA kernels' wrappers."""
