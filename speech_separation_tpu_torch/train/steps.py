"""Train and eval step factories (counterpart of ``train/steps.py``).

:func:`make_upit_waveform_steps` runs the whole pipeline on the device from
padded waveforms: int16 dequantization → STFT (the ``stft_cuda`` kernel) →
PSM features → ``UPitBlstm`` training forward (the BiLSTM training kernels)
→ PIT loss → backward → Adam. :func:`make_time_domain_steps` trains
Conv-TasNet wave to wave on the negative permutation-best SI-SDR, through the
module's own autograd or, with ``pallas_trunk=True``, through the TCN trunk's
training kernels (``models/tasnet_serving.py::train_apply``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses.pit import pit_loss, pit_si_sdr_loss
from ..ops.features import psm_features
from ..ops.quant import dequant_i16
from .state import TrainState

__all__ = ["make_upit_waveform_steps", "make_time_domain_steps"]


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

    def train_step(state: TrainState, mix, sources, frame_lengths):
        state.optimizer.zero_grad(set_to_none=True)
        loss = _loss(mix, sources, frame_lengths, state.generator)
        loss.backward()
        return state.apply_gradients(), loss.detach()

    @torch.no_grad()
    def eval_step(state: TrainState, mix, sources, frame_lengths):
        return _loss(mix, sources, frame_lengths, None)

    return train_step, eval_step


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
