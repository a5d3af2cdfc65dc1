"""Framing and overlap-add on tensors (counterpart of ``ops/framing.py``).

- when ``size == k * hop`` a signal padded to ``(frames + k - 1) * hop`` is
  a view of ``hop``-chunks, and frame ``j`` is chunks ``j .. j+k-1``;
- overlap-add is the exact adjoint: split each frame into ``k`` chunks and sum
  the ``k`` shifted copies.

Both ops are batched over any leading axes.
"""

from __future__ import annotations

import torch

__all__ = ["num_frames", "num_samples", "frame_signal", "overlap_add"]


def num_frames(samples: int, size: int, shift: int) -> int:
    """Frame count for `samples` time steps: ceil((samples - size + shift)/shift)."""
    return -(-(samples - size + shift) // shift)


def num_samples(frames: int, size: int, shift: int) -> int:
    """Inverse of :func:`num_frames`."""
    return frames * shift + size - shift


def frame_signal(signal: torch.Tensor, size: int, shift: int) -> torch.Tensor:
    """Chop ``signal[..., t]`` into overlapping frames ``[..., frames, size]``.

    The signal must already be padded to a whole number of frames
    (``num_samples(frames, size, shift)`` samples). ``size`` must be a
    multiple of ``shift``.
    """
    if size % shift != 0:
        raise ValueError(f"size {size} must be a multiple of shift {shift}")
    total = signal.shape[-1]
    frames = (total - size + shift) // shift
    if num_samples(frames, size, shift) != total:
        raise ValueError(
            f"signal length {total} is not a whole number of frames for "
            f"size={size}, shift={shift}"
        )
    return signal.unfold(-1, size, shift)


def overlap_add(frames: torch.Tensor, shift: int) -> torch.Tensor:
    """Adjoint of :func:`frame_signal`: sum overlapping frames into a signal.

    ``frames`` has shape ``[..., n_frames, size]`` with ``size`` a multiple of
    ``shift``; the result has ``num_samples(n_frames, size, shift)`` samples.
    """
    *lead, n_frames, size = frames.shape
    if size % shift != 0:
        raise ValueError(f"size {size} must be a multiple of shift {shift}")
    k = size // shift
    chunks = frames.reshape(*lead, n_frames, k, shift)
    total = frames.new_zeros((*lead, n_frames + k - 1, shift))
    for c in range(k):
        total[..., c : c + n_frames, :] += chunks[..., c, :]
    return total.reshape(*lead, (n_frames + k - 1) * shift)
