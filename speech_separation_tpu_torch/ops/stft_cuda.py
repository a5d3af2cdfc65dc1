"""Fused STFT analysis kernel (counterpart of ``ops/stft_pallas.py``).

:func:`stft_cuda` runs ``csrc/stft_analysis.cu`` on the unpadded signal:
framing (the fade pads folded into the index), window and a real FFT in one
pass, written as interleaved complex64 and returned as a view with no copy.
The window is a table the kernel reads (``window``: ``"blackman"`` or
``"sqrt_hann"``, ``windows.analysis_window``), so either runs the same code.
Its plain version is ``stft.stft(method="matmul")``, which it takes where
``dispatch.use_plain`` says (a CPU tensor, or inside ``plain_versions()``);
otherwise it launches the kernel or raises.

:func:`stft_fft_plain` repeats the kernel's algorithm in PyTorch (the same
twiddle table, Stockham radix-4 stages, split step and index arithmetic), so
the CPU tests can hold that decomposition against the JAX package. Nothing on
the main path calls it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .dispatch import use_plain
from .stft import stft, stft_frame_count
from .windows import analysis_window

__all__ = ["stft_cuda", "stft_fft_plain", "fft_table", "KERNEL_SIZES"]

KERNEL_SIZES = tuple(2**e for e in range(4, 11))  # 16 .. 1024


def _check_size(size: int, shift: int) -> None:
    if size not in KERNEL_SIZES:
        raise ValueError(f"stft_cuda: size {size} is not a power of two in [16, 1024]")
    if shift < 1 or size % shift != 0:
        raise ValueError(f"stft_cuda: shift {shift} does not divide size {size}")


def _fft_table_np(size: int, window: str = "blackman") -> np.ndarray:
    """``[3 * size]`` float64: the analysis window, then ``exp(-2 pi i k / size)``
    for ``k < size`` as (re, im) pairs."""
    ang = -2.0 * np.pi * np.arange(size, dtype=np.float64) / size
    twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=-1).reshape(-1)
    return np.concatenate([analysis_window(size, window=window), twiddles])


@functools.lru_cache(maxsize=32)
def fft_table(size: int, device=None, window: str = "blackman") -> torch.Tensor:
    """The kernel's fp32 table, rounded once from float64 per (size, device,
    window); read-only."""
    with torch.inference_mode(False):
        return torch.as_tensor(_fft_table_np(size, window), dtype=torch.float32, device=device)


def stft_fft_plain(
    signal: torch.Tensor, size: int = 256, shift: int = 128, *, fading: bool = True,
    window: str = "blackman",
) -> torch.Tensor:
    """The kernel's algorithm in PyTorch: ``[B, frames, size//2+1]`` complex64.

    Reads the unpadded signal (sample ``f * shift + n - pad`` of frame ``f``,
    zero outside it), windows the (even, odd) pairs into ``size/2`` complex
    points, runs Stockham radix-4 stages (radix 2 last when needed) with
    twiddles from :func:`fft_table`, then the split step to real-FFT bins.
    """
    if signal.dim() == 1:
        return stft_fft_plain(signal[None], size, shift, fading=fading, window=window)[0]
    _check_size(size, shift)
    x = signal.to(torch.float32)
    batch, samples = x.shape
    pad = size - shift if fading else 0
    frames = stft_frame_count(samples, size, shift, fading)
    half = size // 2
    table = fft_table(size, x.device, window)
    taper = table[:size]
    tw = torch.complex(table[size::2], table[size + 1 :: 2])

    idx = (torch.arange(frames, device=x.device)[:, None] * shift
           + torch.arange(size, device=x.device)[None, :] - pad)
    inside = (idx >= 0) & (idx < samples)
    xs = x[:, idx.clamp(0, max(samples - 1, 0))] * inside * taper
    z = torch.complex(xs[..., 0::2], xs[..., 1::2])  # [B, F, half]

    lead = z.shape[:-1]
    n, s = half, 1
    while n >= 4:  # y[q + s (4p + r)] from x[q + s (p + r n/4)]
        n1 = n // 4
        a, b, c, d = z.reshape(*lead, 4, n1, s).unbind(-3)
        step = size // n
        p = torch.arange(n1, device=x.device)[:, None]
        apc, amc, bpd, jbmd = a + c, a - c, b + d, 1j * (b - d)
        z = torch.stack(
            [apc + bpd, tw[p * step] * (amc - jbmd), tw[2 * p * step] * (apc - bpd),
             tw[3 * p * step] * (amc + jbmd)],
            dim=-2,
        ).reshape(*lead, half)
        n, s = n1, 4 * s
    if n == 2:  # y[q] = x[q] + x[q + s], y[q + s] = x[q] - x[q + s]
        a, b = z.reshape(*lead, 2, s).unbind(-2)
        z = torch.cat([a + b, a - b], dim=-1)

    k = torch.arange(half + 1, device=x.device)
    zk = z[..., k % half]
    zm = z[..., (half - k) % half].conj()
    return 0.5 * (zk + zm) + tw[k] * (-0.5j * (zk - zm))


def stft_cuda(
    signal: torch.Tensor, size: int = 256, shift: int = 128, *, fading: bool = True,
    window: str = "blackman",
) -> torch.Tensor:
    """Batched complex STFT ``[B, frames, size//2+1]`` of ``signal`` ``[B, samples]``.

    A 1-D signal gives ``[frames, size//2+1]``. On a CUDA tensor ``size`` must
    be a power of two in [16, 1024] (``ValueError`` otherwise).
    """
    if signal.dim() == 1:
        return stft_cuda(signal[None], size, shift, fading=fading, window=window)[0]
    if use_plain(signal):
        return stft(signal, size, shift, fading=fading, method="matmul", window=window)
    if signal.device.type != "cuda":
        raise ValueError(f"stft_cuda: unsupported device {signal.device}")
    if signal.dim() != 2:
        raise ValueError(f"stft_cuda: expected [B, samples], got {tuple(signal.shape)}")
    if not signal.is_floating_point():
        raise TypeError(f"stft_cuda: expected a float signal, got {signal.dtype}")
    _check_size(size, shift)
    signal = signal.to(torch.float32).contiguous()
    batch, samples = signal.shape
    frames = max(0, stft_frame_count(samples, size, shift, fading))
    bins = size // 2 + 1
    out = torch.empty((batch, frames, bins, 2), dtype=torch.float32, device=signal.device)
    if batch and frames:
        table = fft_table(size, signal.device, window)
        with torch.cuda.device(signal.device):
            code = _build.library().sst_stft_analysis(
                signal.data_ptr(), table.data_ptr(), out.data_ptr(),
                batch, samples, frames, size, shift, size - shift if fading else 0,
                torch.cuda.current_stream().cuda_stream,
            )
        _build.check(code, "stft_analysis")
        stft_cuda.launches += 1
    return torch.view_as_complex(out)


stft_cuda.launches = 0
