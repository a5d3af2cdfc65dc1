"""Separation metrics (counterpart of ``metrics/``): SI-SDR, its
permutation-best form and streaming mean, and BSS-eval."""

from .bss_eval import (
    BssEvalImagesResult,
    BssEvalResult,
    bss_eval_images,
    bss_eval_sources,
)
from .sisdr import MeanSiSdr, permute_si_sdr, si_sdr_np

__all__ = [
    "BssEvalImagesResult",
    "BssEvalResult",
    "bss_eval_images",
    "bss_eval_sources",
    "MeanSiSdr",
    "permute_si_sdr",
    "si_sdr_np",
]
