"""Batched STFT / iSTFT on tensors (counterpart of ``ops/stft.py``).

Semantics match the JAX package at fp32:

- analysis: optional fade-in/out zero padding of ``size - shift`` on both
  sides, trailing zero padding to a whole number of frames, Blackman
  windowing, DFT → ``[..., frames, size // 2 + 1]``;
- synthesis: per-frame inverse DFT, multiply by the net biorthogonal synthesis
  window (see ``windows.py``), overlap-add, fade compensation crop.

``window`` picks the analysis window (``windows.analysis_window``): the
default ``"blackman"`` is the JAX package's, ``"sqrt_hann"`` the port's own
(TF-GridNet); the synthesis side is always the dual of the window that
analysed.

Two compute paths:

``method="matmul"``  (default) DFT by ``torch.matmul`` against a precomputed
                     ``[size, 2 * bins]`` basis with the window folded in.
                     This is the plain version of the analysis kernel in
                     ``stft_cuda.py``.
``method="fft"``     ``torch.fft.rfft`` / ``irfft``: the oracle path.

The DSP runs in fp32, as the JAX package's ``Precision.HIGHEST``: on a GPU,
``torch.backends.cuda.matmul.allow_tf32`` must stay False (its default).
"""

from __future__ import annotations

import functools
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from .framing import frame_signal, num_frames, num_samples, overlap_add
from .windows import analysis_window, biorthogonal_synthesis_window

__all__ = [
    "stft",
    "istft",
    "stft_frame_count",
    "analysis_basis",
    "synthesis_basis",
    "pad_for_stft",
]

Method = Literal["fft", "matmul"]


def stft_frame_count(samples: int, size: int, shift: int, fading: bool = True) -> int:
    """Number of STFT frames produced for a ``samples``-long signal."""
    if fading:
        samples = samples + 2 * (size - shift)
    return num_frames(samples, size, shift)


def _analysis_basis_np(size: int, window: str = "blackman") -> np.ndarray:
    """Windowed forward-DFT basis ``[size, 2 * bins]`` (cos block, -sin block)."""
    bins = size // 2 + 1
    win = analysis_window(size, window=window)
    n = np.arange(size, dtype=np.float64)[:, None]
    f = np.arange(bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * f / size
    return np.concatenate([win[:, None] * np.cos(ang), win[:, None] * -np.sin(ang)], axis=1)


def _synthesis_basis_np(size: int, shift: int, window: str = "blackman") -> np.ndarray:
    """Inverse-DFT basis ``[2 * bins, size]`` with the synthesis window folded in.

    Rows are real parts then imaginary parts. DC and Nyquist imaginary rows are
    zero, matching a real-output irFFT.
    """
    bins = size // 2 + 1
    ws = biorthogonal_synthesis_window(size, shift, window=window)
    n = np.arange(size, dtype=np.float64)[None, :]
    f = np.arange(bins, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * n * f / size
    scale = np.full((bins, 1), 2.0 / size)
    scale[0] = scale[-1] = 1.0 / size  # DC and Nyquist appear once in the full spectrum
    re_rows = scale * np.cos(ang) * ws[None, :]
    im_rows = -scale * np.sin(ang) * ws[None, :]
    im_rows[0] = 0.0
    im_rows[-1] = 0.0
    return np.concatenate([re_rows, im_rows], axis=0)


@functools.lru_cache(maxsize=32)
def analysis_basis(size: int, device=None, window: str = "blackman") -> torch.Tensor:
    """fp32 basis, built once per (size, device, window) from the float64 one; read-only."""
    with torch.inference_mode(False):
        return torch.as_tensor(_analysis_basis_np(size, window), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=32)
def synthesis_basis(size: int, shift: int, device=None, window: str = "blackman") -> torch.Tensor:
    """fp32 basis, built once per (size, shift, device, window); read-only."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            _synthesis_basis_np(size, shift, window), dtype=torch.float32, device=device
        )


def pad_for_stft(signal: torch.Tensor, size: int, shift: int, fading: bool) -> torch.Tensor:
    """Fade pads of ``size - shift`` (if ``fading``), then zeros to whole frames."""
    if fading:
        signal = F.pad(signal, (size - shift, size - shift))
    samples = signal.shape[-1]
    total = num_samples(num_frames(samples, size, shift), size, shift)
    if total != samples:
        signal = F.pad(signal, (0, total - samples))
    return signal


def stft(
    signal: torch.Tensor,
    size: int = 256,
    shift: int = 128,
    *,
    fading: bool = True,
    method: Method = "matmul",
    window: str = "blackman",
) -> torch.Tensor:
    """Batched STFT of ``signal[..., t]`` → complex ``[..., frames, size//2+1]``."""
    signal = pad_for_stft(signal.to(torch.float32), size, shift, fading)
    frames = frame_signal(signal, size, shift)
    if method == "fft":
        win = torch.as_tensor(
            analysis_window(size, window=window), dtype=torch.float32, device=signal.device
        )
        return torch.fft.rfft(frames * win, dim=-1)
    basis = analysis_basis(size, signal.device, window)
    flat = torch.matmul(frames, basis)
    bins = size // 2 + 1
    return torch.complex(flat[..., :bins], flat[..., bins:])


def istft(
    spectrum: torch.Tensor,
    size: int = 256,
    shift: int = 128,
    *,
    fading: bool = True,
    method: Method = "matmul",
    window: str = "blackman",
) -> torch.Tensor:
    """Inverse STFT of ``[..., frames, size//2+1]`` → ``[..., samples]``.

    With ``fading=True`` the fade pads added by :func:`stft` are cropped, so
    ``istft(stft(x))`` reconstructs ``x`` (up to the trailing frame padding).
    """
    bins = size // 2 + 1
    if spectrum.shape[-1] != bins:
        raise ValueError(f"expected {bins} bins, got {spectrum.shape[-1]}")
    if method == "fft":
        ws = torch.as_tensor(
            biorthogonal_synthesis_window(size, shift, window=window),
            dtype=torch.float32,
            device=spectrum.device,
        )
        frames_td = torch.fft.irfft(spectrum, n=size, dim=-1) * ws
    else:
        flat = torch.cat([spectrum.real, spectrum.imag], dim=-1).to(torch.float32)
        basis = synthesis_basis(size, shift, spectrum.device, window)
        frames_td = torch.matmul(flat, basis)
    signal = overlap_add(frames_td, shift)
    if fading:
        edge = size - shift
        signal = signal[..., edge : signal.shape[-1] - edge]
    return signal
