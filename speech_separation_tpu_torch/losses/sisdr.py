"""Reconstruction loss of the VQ-VAE family (counterpart of ``losses/sisdr.py``)."""

from __future__ import annotations

import torch

__all__ = ["summed_squared_error"]


def summed_squared_error(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Batch mean of per-utterance summed squared error, ``[B, T, F]`` inputs."""
    return torch.mean(torch.sum(torch.square(preds - targets), dim=tuple(range(1, preds.dim()))))
