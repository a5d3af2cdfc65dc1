"""Spectral features on tensors (counterpart of ``ops/features.py``).

Training computes its features from raw waveforms inside the step, as the
JAX package does: the mixture magnitude (the network's input) and the
phase-sensitive-mask labels, with the phase trig reduced to real arithmetic:

    cos(∠mix − ∠s) = (Re_mix·Re_s + Im_mix·Im_s) / (|mix| · |s|)
    ⇒ psm_label      = (Re_mix·Re_s + Im_mix·Im_s) / |mix|
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .stft_cuda import stft_cuda

__all__ = ["SpectralFeatures", "psm_features", "magnitude_angle"]

_EPS = 1e-12


class SpectralFeatures(NamedTuple):
    magnitude: torch.Tensor  # [B, T, F] mixture magnitude (model input)
    cos_angle: torch.Tensor  # [B, T, F] cos of mixture phase
    sin_angle: torch.Tensor  # [B, T, F] sin of mixture phase
    labels: torch.Tensor  # [B, T, num_speakers * F] PSM targets


def magnitude_angle(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(|X|, cos ∠X, sin ∠X) from a complex spectrum, avoiding atan2."""
    re, im = spec.real, spec.imag
    mag = torch.sqrt(re * re + im * im)
    inv = 1.0 / torch.clamp(mag, min=_EPS)
    return mag, re * inv, im * inv


def psm_features(
    mix: torch.Tensor,
    sources: torch.Tensor,
    size: int = 256,
    shift: int = 128,
) -> SpectralFeatures:
    """Mixture magnitude and phase and PSM labels from raw waveforms.

    ``mix``: ``[B, samples]``; ``sources``: ``[B, num_speakers, samples]``.
    The mixture and the sources go through one ``stft_cuda`` analysis (its
    plain matmul where ``dispatch.use_plain`` says).
    """
    b, s, samples = sources.shape
    waves = torch.cat([mix.reshape(b, samples), sources.reshape(b * s, samples)])
    spec = stft_cuda(waves, size, shift)
    mix_spec, src_spec = spec[:b], spec[b:].reshape(b, s, *spec.shape[1:])
    mix_re, mix_im = mix_spec.real, mix_spec.imag
    mag = torch.sqrt(mix_re * mix_re + mix_im * mix_im)
    inv_mag = 1.0 / torch.clamp(mag, min=_EPS)
    # |s| cos(∠mix − ∠s) = (Re_mix Re_s + Im_mix Im_s) / |mix|
    psm = (mix_re[:, None] * src_spec.real + mix_im[:, None] * src_spec.imag) * inv_mag[:, None]
    t, f = psm.shape[-2:]
    labels = psm.movedim(1, 2).reshape(b, t, s * f)
    return SpectralFeatures(mag, mix_re * inv_mag, mix_im * inv_mag, labels)
