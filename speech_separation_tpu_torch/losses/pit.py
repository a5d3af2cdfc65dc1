"""Permutation-invariant training loss (counterpart of ``losses/pit.py``).

The reference's semantics (``uPIT_baseline.ipynb`` cell 28), for any speaker
count through a static permutation table:

- a mask over each utterance's valid frames is applied to the *predictions
  only* (labels are zero beyond the valid region by construction);
- per permutation: squared error summed over time and features, divided by
  the utterance's valid length;
- the minimum over permutations per utterance, **summed** over the batch
  (``reduction="mean"`` averages, ``"none"`` returns ``[B]``).

:func:`pit_loss_packed` is the same loss over sequence-packed rows, per
utterance. :func:`pit_si_sdr_loss` is the time-domain objective (Conv-TasNet): the
negative permutation-best mean SI-SDR over waveforms.
"""

from __future__ import annotations

import itertools

import torch

__all__ = ["pairwise_pit_costs", "pit_loss", "pit_loss_packed", "pit_si_sdr_loss"]


def _split_speakers(x: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """[B, T, S*F] → [B, T, S, F] (4-D passes through)."""
    if x.dim() == 4:
        return x
    b, t, sf = x.shape
    if sf % num_speakers:
        raise ValueError(f"feature dim {sf} not divisible by {num_speakers} speakers")
    return x.reshape(b, t, num_speakers, sf // num_speakers)


def pairwise_pit_costs(
    preds: torch.Tensor,
    labels: torch.Tensor,
    lengths: torch.Tensor,
    num_speakers: int = 2,
) -> torch.Tensor:
    """Per-utterance cost of assigning prediction i to label j: ``[B, S, S]``.

    ``preds`` / ``labels``: ``[B, T, S, F]`` or ``[B, T, S*F]``;
    ``lengths``: ``[B]`` valid frame counts.
    """
    preds = _split_speakers(preds, num_speakers)
    labels = _split_speakers(labels, num_speakers)
    t = preds.shape[1]
    lengths = torch.as_tensor(lengths, device=preds.device)
    mask = (torch.arange(t, device=preds.device)[None, :] < lengths[:, None]).to(preds.dtype)
    masked = preds * mask[:, :, None, None]
    diff = masked[:, :, :, None, :] - labels[:, :, None, :, :]  # [B, T, S_pred, S_label, F]
    return diff.square().sum(dim=(1, 4))


def pit_loss(
    preds: torch.Tensor,
    labels: torch.Tensor,
    lengths: torch.Tensor,
    num_speakers: int = 2,
    reduction: str = "sum",
) -> torch.Tensor:
    """Masked, length-normalised PIT squared-error loss."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    costs = pairwise_pit_costs(preds, labels, lengths, num_speakers)
    perms = torch.tensor(
        list(itertools.permutations(range(num_speakers))), device=costs.device
    )  # [S!, S]
    idx = torch.arange(num_speakers, device=costs.device)
    per_perm = costs[:, idx[None, :], perms].sum(dim=-1)  # [B, S!]
    lengths = torch.as_tensor(lengths, device=preds.device)
    per_utt = per_perm.min(dim=1).values / lengths.to(preds.dtype)
    if reduction == "sum":
        return per_utt.sum()
    if reduction == "mean":
        return per_utt.mean()
    return per_utt


def pit_loss_packed(
    preds: torch.Tensor,
    labels: torch.Tensor,
    frame_seg: torch.Tensor,
    num_speakers: int = 2,
    num_segments: int = 8,
    reduction: str = "sum",
) -> torch.Tensor:
    """:func:`pit_loss` over sequence-packed rows (``data/packing.py``).

    ``frame_seg [B, T]`` gives every frame its segment within its row, in
    ``[0, num_segments)``, or ``-1`` for tail frames of no utterance, which
    match no segment and so add nothing. The permutation search and the
    length normalisation run per segment, so the sum equals the sum of
    :func:`pit_loss` over the utterances run one by one; a segment with no
    frames adds 0. ``"mean"`` divides by the segments that have frames,
    ``"none"`` returns ``[B, num_segments]``."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    preds = _split_speakers(preds, num_speakers)
    labels = _split_speakers(labels, num_speakers)
    diff = preds[:, :, :, None, :] - labels[:, :, None, :, :]  # [B, T, S_pred, S_label, F]
    pair_frame = diff.square().sum(dim=-1)  # [B, T, S_pred, S_label]
    segments = torch.arange(num_segments, device=frame_seg.device)
    onehot = (frame_seg[..., None] == segments).to(preds.dtype)  # [B, T, G]
    seg_pair = torch.einsum("btij,btg->bgij", pair_frame, onehot)  # [B, G, S_pred, S_label]
    seg_len = onehot.sum(dim=1)  # [B, G] frames a segment
    perms = torch.tensor(
        list(itertools.permutations(range(num_speakers))), device=preds.device
    )  # [S!, S]
    idx = torch.arange(num_speakers, device=preds.device)
    per_perm = seg_pair[:, :, idx[None, :], perms].sum(dim=-1)  # [B, G, S!]
    best = per_perm.min(dim=-1).values
    per_seg = torch.where(seg_len > 0, best / seg_len.clamp(min=1.0), 0.0)
    if reduction == "sum":
        return per_seg.sum()
    if reduction == "mean":
        return per_seg.sum() / (seg_len > 0).sum().clamp(min=1)
    return per_seg


def pit_si_sdr_loss(
    est: torch.Tensor,
    refs: torch.Tensor,
    sample_lengths: torch.Tensor,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Negative permutation-best mean SI-SDR: ``est`` / ``refs`` ``[B, S,
    samples]``, ``sample_lengths [B]``. Samples past an utterance's length
    are masked out of both signals. The noise term is an explicit
    subtraction: the algebraic ``‖e‖² − 2α<e,r> + ‖αr‖²`` cancels
    catastrophically in fp32 when ``est ≈ ref``."""
    b, s, t = est.shape
    lengths = torch.as_tensor(sample_lengths, device=est.device)
    mask = (torch.arange(t, device=est.device)[None, None, :] < lengths[:, None, None]).to(est.dtype)
    est = est * mask
    refs = refs * mask
    dot = torch.einsum("bet,brt->ber", est, refs)  # [B, S_est, S_ref]
    ref_energy = refs.square().sum(dim=-1)[:, None, :]  # [B, 1, S_ref]
    scale = dot / (ref_energy + eps)
    target_energy = scale.square() * ref_energy  # ‖α·r‖²
    noise = est[:, :, None, :] - scale[..., None] * refs[:, None, :, :]
    noise_energy = noise.square().sum(dim=-1)
    pair_si_sdr = 10.0 * torch.log10(target_energy / (noise_energy + eps) + eps)
    perms = torch.tensor(list(itertools.permutations(range(s))), device=est.device)  # [S!, S]
    idx = torch.arange(s, device=est.device)
    per_perm = pair_si_sdr[:, idx[None, :], perms].mean(dim=-1)  # [B, S!]
    return -per_perm.max(dim=1).values.mean()
