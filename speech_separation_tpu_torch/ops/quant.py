"""int16 wire quantization (counterpart of ``ops/quant.py``).

Upload: 16-bit PCM decodes to ``i / 32768`` exactly, so int16 counts plus
:func:`dequant_i16` on the device reproduce the float decoder bit for bit at
half the bytes. Download: estimates are not bounded by ±1.0, so
:func:`quantize_estimates_i16` scales each signal by ``m = max(peak, 1)``,
never clipping, and ships ``m`` beside the codes;
:func:`dequantize_estimates_i16` undoes it on the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dequant_i16", "quantize_estimates_i16", "dequantize_estimates_i16"]


def dequant_i16(wave: torch.Tensor) -> torch.Tensor:
    """int16 (or the int32 mix lane) → float32 at 1/32768; floats pass through."""
    if wave.dtype in (torch.int16, torch.int32):
        return wave.to(torch.float32) * (1.0 / 32768.0)
    return wave


def quantize_estimates_i16(wave: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes int16 [..., samples], scale float32 [...])`` with
    ``wave ≈ codes * scale / 32767`` and no clipping at any amplitude."""
    peak = wave.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(peak, min=1.0)
    codes = torch.round(wave / scale * 32767.0).to(torch.int16)
    return codes, scale[..., 0].to(torch.float32)


def dequantize_estimates_i16(codes: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`quantize_estimates_i16` (numpy)."""
    return codes.astype(np.float32) * (np.asarray(scale, dtype=np.float32)[..., None] / 32767.0)
