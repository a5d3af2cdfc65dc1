"""Train and eval step factories (counterpart of ``train/steps.py``).

:func:`make_upit_waveform_steps` runs the whole pipeline on the device from
padded waveforms: int16 dequantization → STFT (the ``stft_cuda`` kernel) →
PSM features → ``UPitBlstm`` training forward (the BiLSTM training kernels)
→ PIT loss → backward → Adam.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses.pit import pit_loss
from ..ops.features import psm_features
from ..ops.quant import dequant_i16
from .state import TrainState

__all__ = ["make_upit_waveform_steps"]


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
