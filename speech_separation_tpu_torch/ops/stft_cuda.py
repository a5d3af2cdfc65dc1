"""Fused STFT analysis kernel (counterpart of ``ops/stft_pallas.py``).

:func:`stft_cuda` pads the signal on its device as :func:`stft.stft` does,
then runs ``csrc/stft_analysis.cu``: framing, window and DFT in one pass, with
the framed ``[F, size]`` intermediate never written. Its plain version is
``stft.stft(method="matmul")``, which it takes only for a tensor on the CPU;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .framing import num_frames
from .stft import analysis_basis, pad_for_stft, stft

__all__ = ["stft_cuda"]


def stft_cuda(
    signal: torch.Tensor, size: int = 256, shift: int = 128, *, fading: bool = True
) -> torch.Tensor:
    """Batched complex STFT ``[B, frames, size//2+1]`` of ``signal`` ``[B, samples]``.

    A 1-D signal gives ``[frames, size//2+1]``.
    """
    if signal.dim() == 1:
        return stft_cuda(signal[None], size, shift, fading=fading)[0]
    if signal.device.type == "cpu":
        return stft(signal, size, shift, fading=fading, method="matmul")
    if signal.device.type != "cuda":
        raise ValueError(f"stft_cuda: unsupported device {signal.device}")
    if signal.dim() != 2:
        raise ValueError(f"stft_cuda: expected [B, samples], got {tuple(signal.shape)}")
    if not signal.is_floating_point():
        raise TypeError(f"stft_cuda: expected a float signal, got {signal.dtype}")
    padded = pad_for_stft(signal.to(torch.float32), size, shift, fading).contiguous()
    batch, samples = padded.shape
    frames = num_frames(samples, size, shift)
    bins = size // 2 + 1
    basis = analysis_basis(size, padded.device)
    out = torch.empty((batch, frames, 2 * bins), dtype=torch.float32, device=padded.device)
    with torch.cuda.device(padded.device):
        code = _build.library().sst_stft_analysis(
            padded.data_ptr(), basis.data_ptr(), out.data_ptr(),
            batch, samples, frames, size, shift, 2 * bins,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "stft_analysis")
    stft_cuda.launches += 1
    return torch.complex(out[..., :bins], out[..., bins:])


stft_cuda.launches = 0
