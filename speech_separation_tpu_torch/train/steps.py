"""Train and eval step factories (counterpart of ``train/steps.py``).

:func:`make_upit_waveform_steps` runs the whole pipeline on the device from
padded waveforms: int16 dequantization → STFT (the ``stft_cuda`` kernel) →
PSM features → ``UPitBlstm`` training forward (the BiLSTM training kernels)
→ PIT loss → backward → Adam. :func:`make_upit_packed_steps` does the same
over sequence-packed rows (``data/packing.py``): the recurrences run the
training kernels in their keep mode and the loss is
:func:`~..losses.pit.pit_loss_packed`, per utterance;
:func:`make_upit_packed_resident_steps` takes row indices into a corpus held
on the device (``data/device_dataset.py``). :func:`make_time_domain_steps`
trains Conv-TasNet wave to wave on the negative permutation-best SI-SDR,
through the module's own autograd or, with ``pallas_trunk=True``, through the
TCN trunk's training kernels (``models/tasnet_serving.py::train_apply``).
:func:`make_vae_steps` trains the VQ-VAE codecs on their reconstruction loss
plus their auxiliary losses, every nearest-code search in the
``nearest_code`` kernel.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses.pit import pit_loss, pit_loss_packed, pit_si_sdr_loss
from ..losses.sisdr import summed_squared_error
from ..ops.features import psm_features
from ..ops.quant import dequant_i16
from .state import TrainState

__all__ = [
    "make_upit_waveform_steps",
    "make_upit_packed_steps",
    "make_upit_packed_resident_steps",
    "make_time_domain_steps",
    "make_vae_steps",
]


def make_upit_waveform_steps(
    model,
    size: int = 256,
    shift: int = 128,
    num_speakers: int = 2,
    compute_dtype: torch.dtype | None = None,
    plain: bool = False,
) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)`` over ``(state, mix [B, S], sources [B, n, S],
    frame_lengths [B])``; ``train_step`` returns ``(state, loss)`` and updates
    ``state`` in place, ``eval_step`` returns the loss without dropout.

    ``compute_dtype=torch.bfloat16`` runs the mask network's forward and
    backward in bf16: the fp32 master parameters are cast inside the step,
    the DSP features, the PIT loss and the optimizer update stay fp32, and
    the gradient of the cast hands fp32 gradients to Adam. ``plain=True``
    runs every kernel's plain version instead (the reference path on a GPU).
    ``model`` is the ``UPitBlstm`` whose ``train_forward`` the steps call; the
    state's optimizer holds its parameters (``TrainState.create(model, ...)``).
    """

    def _loss(mix, sources, frame_lengths, generator):
        feats = psm_features(dequant_i16(mix), dequant_i16(sources), size, shift, plain=plain)
        preds = model.train_forward(
            feats.magnitude, generator=generator, compute_dtype=compute_dtype, plain=plain
        )
        return pit_loss(preds.to(torch.float32), feats.labels, frame_lengths, num_speakers)

    return _steps(_loss, lambda mix, sources, frame_lengths: (mix, sources, frame_lengths))


def _packed_loss(model, size, shift, num_speakers, num_segments, compute_dtype, plain):
    """The packed-row loss of :func:`make_upit_packed_steps` and
    :func:`make_upit_packed_resident_steps`."""

    def _loss(mix, sources, frame_seg, generator):
        feats = psm_features(dequant_i16(mix), dequant_i16(sources), size, shift, plain=plain)
        preds = model.train_forward(
            feats.magnitude, generator=generator, compute_dtype=compute_dtype,
            segment_ids=frame_seg, plain=plain,
        )
        return pit_loss_packed(
            preds.to(torch.float32), feats.labels, frame_seg, num_speakers, num_segments
        )

    return _loss


def _steps(loss_fn, arrays: Callable) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)`` over ``loss_fn(*arrays(*args), generator)``."""

    def train_step(state: TrainState, *args):
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(*arrays(*args), state.generator)
        loss.backward()
        return state.apply_gradients(), loss.detach()

    @torch.no_grad()
    def eval_step(state: TrainState, *args):
        return loss_fn(*arrays(*args), None)

    return train_step, eval_step


def make_upit_packed_steps(
    model,
    size: int = 256,
    shift: int = 128,
    num_speakers: int = 2,
    num_segments: int = 8,
    compute_dtype: torch.dtype | None = None,
    plain: bool = False,
) -> tuple[Callable, Callable]:
    """:func:`make_upit_waveform_steps` over sequence-packed rows: ``(state,
    mix [R, row_samples], sources [R, n, row_samples], frame_seg [R,
    row_frames])``, ``frame_seg`` int32 with ``-1`` on tail frames and at
    most ``num_segments`` segments a row.

    Each packed utterance is trained as if alone: the carry gate resets the
    recurrences at every segment change, in both directions (on a GPU, the
    training kernels' keep mode), and :func:`pit_loss_packed` searches the
    permutations and normalises the length per segment. The loss is the sum
    over the utterances, the same sum the unpacked step reports."""
    loss = _packed_loss(model, size, shift, num_speakers, num_segments, compute_dtype, plain)
    return _steps(loss, lambda mix, sources, frame_seg: (mix, sources, frame_seg))


def make_upit_packed_resident_steps(
    model,
    mix_all: torch.Tensor,
    sources_all: torch.Tensor,
    frame_seg_all: torch.Tensor,
    size: int = 256,
    shift: int = 128,
    num_speakers: int = 2,
    num_segments: int = 8,
    compute_dtype: torch.dtype | None = None,
    plain: bool = False,
) -> tuple[Callable, Callable]:
    """:func:`make_upit_packed_steps` over a corpus held on the device
    (``data.device_dataset.ResidentPackedCorpus``): each step takes only
    ``(state, idx [R])``, gathers those rows on the device and runs the same
    packed loss, so its losses and gradients equal the loader-fed steps' on
    the same rows."""
    loss = _packed_loss(model, size, shift, num_speakers, num_segments, compute_dtype, plain)

    def gather(idx):
        idx = idx.to(mix_all.device)
        return (mix_all.index_select(0, idx), sources_all.index_select(0, idx),
                frame_seg_all.index_select(0, idx))

    return _steps(loss, gather)


def make_time_domain_steps(
    model,
    compute_dtype: torch.dtype | None = None,
    pallas_trunk: bool = False,
    plain: bool = False,
) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)`` for a wave-in, wave-out separator
    (``ConvTasNet``) over ``(state, mix [B, samples], sources [B, S,
    samples], sample_lengths [B])``; the loss is :func:`pit_si_sdr_loss` in
    fp32 on the estimates cast back, after int16 dequantization.

    ``pallas_trunk=False`` runs the module's own forward and autograd, in
    fp32 or, with ``compute_dtype=torch.bfloat16``, on the fp32 master
    parameters cast to bf16 inside the step (gLN statistics stay fp32 in the
    module; the cast's gradient hands fp32 gradients to Adam); causal models
    train here. ``pallas_trunk=True`` (bf16 only, gLN models only) runs the
    TCN trunk, forward and backward, in the training kernels
    (``train_apply``); ``plain=True`` then runs their plain versions, the
    reference path on a GPU.
    """
    if pallas_trunk and getattr(model, "causal", False):
        # the kernel trunk implements the gLN, SAME-padded blocks only: a causal
        # config trained through it would yield a gLN checkpoint that claims cLN
        raise ValueError(
            "pallas_trunk=True trains the gLN/SAME-padded trunk; "
            "causal ConvTasNet must train via the module path (pallas_trunk=False)"
        )
    if pallas_trunk:
        from ..models.tasnet_serving import train_apply

        def forward(mix):
            return train_apply(model, mix, plain=plain)

    elif compute_dtype is None:
        forward = model
    else:

        def forward(mix):
            params = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
            return torch.func.functional_call(model, params, (mix,))

    def _loss(mix, sources, sample_lengths):
        est = forward(dequant_i16(mix)).to(torch.float32)
        return pit_si_sdr_loss(est, dequant_i16(sources), sample_lengths)

    def train_step(state: TrainState, mix, sources, sample_lengths):
        state.optimizer.zero_grad(set_to_none=True)
        loss = _loss(mix, sources, sample_lengths)
        loss.backward()
        return state.apply_gradients(), loss.detach()

    @torch.no_grad()
    def eval_step(state: TrainState, mix, sources, sample_lengths):
        return _loss(mix, sources, sample_lengths)

    return train_step, eval_step


def make_vae_steps(
    model,
    loss_fn: Callable = summed_squared_error,
    schedule: Callable[[int], dict] | None = None,
    plain: bool = False,
) -> tuple[Callable, Callable]:
    """``(train_step, eval_step)`` for the VQ-VAE codecs over ``(state,
    inputs, targets)``: the reconstruction loss plus the model's own auxiliary
    losses (KL, or commitment and codebook), ``loss + sum(aux)``.

    ``train_step`` returns ``(state, loss, recon)`` and updates ``state`` in
    place; ``eval_step`` returns ``(loss, recon, preds)`` from the
    deterministic forward. ``schedule(step)`` gives extra model keyword
    arguments (the Gumbel codec's ``temperature`` and ``kl_scale``) for the
    training forward only. The Gumbel noise comes from the state's generator.
    ``plain=True`` runs the nearest-code search's plain version."""

    def _loss(inputs, targets, generator, deterministic, extra=None):
        kwargs = dict(deterministic=deterministic, generator=generator, plain=plain)
        if extra:
            kwargs.update(extra)
        preds, aux_losses = model(inputs, **kwargs)
        recon = loss_fn(preds, targets)
        return recon + sum(aux_losses), recon, preds

    def train_step(state: TrainState, inputs, targets):
        state.optimizer.zero_grad(set_to_none=True)
        extra = schedule(state.step) if schedule is not None else None
        loss, recon, _ = _loss(inputs, targets, state.generator, False, extra)
        loss.backward()
        return state.apply_gradients(), loss.detach(), recon.detach()

    @torch.no_grad()
    def eval_step(state: TrainState, inputs, targets):
        return _loss(inputs, targets, None, True)

    return train_step, eval_step
