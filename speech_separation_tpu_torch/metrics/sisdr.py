"""SI-SDR metrics (counterpart of ``metrics/sisdr.py``): per utterance,
permutation-best, and a streaming mean.

- :func:`si_sdr_np` — one utterance in float64 numpy, the projection formula;
- :func:`permute_si_sdr` — the best over speaker assignments of the mean
  SI-SDR, for N speakers;
- :class:`MeanSiSdr` — a streaming mean of :func:`~..losses.sisdr.si_sdr`
  over batches, its sums kept as tensors on the batches' device.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from ..losses.sisdr import si_sdr

__all__ = ["si_sdr_np", "permute_si_sdr", "MeanSiSdr"]


def si_sdr_np(reference: np.ndarray, estimate: np.ndarray) -> float:
    """Host-side SI-SDR of one utterance (float64 numpy)."""
    reference = np.asarray(reference, dtype=np.float64)
    estimate = np.asarray(estimate, dtype=np.float64)
    target = np.sum(estimate * reference) * reference / np.sum(np.square(reference))
    noise = estimate - target
    return float(10.0 * np.log10(np.sum(np.square(target)) / np.sum(np.square(noise))))


def permute_si_sdr(references, estimates) -> float:
    """Best-over-assignments mean SI-SDR for one utterance; ``references`` /
    ``estimates`` are sequences of 1-D waveforms of equal count."""
    n = len(references)
    assert len(estimates) == n
    scores = np.array([[si_sdr_np(r, e) for e in estimates] for r in references])  # [ref, est]
    best = -np.inf
    for perm in itertools.permutations(range(n)):
        best = max(best, float(np.mean(scores[np.arange(n), perm])))
    return best


class MeanSiSdr(NamedTuple):
    """Streaming mean SI-SDR: ``MeanSiSdr.init().update(targets, preds)...result()``;
    the sums move to the batches' device at the first update."""

    total: torch.Tensor
    count: torch.Tensor

    @classmethod
    def init(cls) -> "MeanSiSdr":
        return cls(total=torch.zeros(()), count=torch.zeros(()))

    def update(self, targets: torch.Tensor, preds: torch.Tensor) -> "MeanSiSdr":
        values = si_sdr(preds, targets)
        total, count = self.total.to(values.device), self.count.to(values.device)
        return MeanSiSdr(total=total + torch.sum(values), count=count + values.shape[0])

    def result(self) -> torch.Tensor:
        return self.total / torch.clamp(self.count, min=1.0)
