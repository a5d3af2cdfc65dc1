"""Spectral features on tensors (counterpart of ``ops/features.py``)."""

from __future__ import annotations

import torch

__all__ = ["magnitude_angle"]

_EPS = 1e-12


def magnitude_angle(spec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(|X|, cos ∠X, sin ∠X) from a complex spectrum, avoiding atan2."""
    re, im = spec.real, spec.imag
    mag = torch.sqrt(re * re + im * im)
    inv = 1.0 / torch.clamp(mag, min=_EPS)
    return mag, re * inv, im * inv
