"""SI-SDR and summed-square reconstruction losses (counterpart of
``losses/sisdr.py``).

``summed_squared_error`` is the batch mean of per-utterance *summed* squared
error (the VQ-VAE family's loss); :func:`si_sdr` is the scale-invariant SDR
with the projection ``target = <ŷ, y> y / ‖y‖²`` over the time axis, and
:func:`si_sdr_loss` its negative batch mean.
"""

from __future__ import annotations

import torch

__all__ = ["summed_squared_error", "si_sdr", "si_sdr_loss"]


def summed_squared_error(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Batch mean of per-utterance summed squared error, ``[B, T, F]`` inputs."""
    return torch.mean(torch.sum(torch.square(preds - targets), dim=tuple(range(1, preds.dim()))))


def si_sdr(preds: torch.Tensor, targets: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Scale-invariant SDR in dB per batch element: ``preds`` / ``targets``
    ``[B, T]`` or ``[B, T, 1]`` waveforms, on their own device."""
    if preds.dim() == 3:
        preds = preds[..., 0]
    if targets.dim() == 3:
        targets = targets[..., 0]
    dot = torch.sum(preds * targets, dim=-1, keepdim=True)
    energy = torch.sum(torch.square(targets), dim=-1, keepdim=True)
    target = dot * targets / (energy + eps)
    noise = preds - target
    ratio = torch.sum(torch.square(target), dim=-1) / (torch.sum(torch.square(noise), dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def si_sdr_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Negative batch-mean SI-SDR."""
    return -torch.mean(si_sdr(preds, targets))
