"""uPIT BLSTM mask-estimation separator (counterpart of ``models/upit.py``).

:class:`UPitBlstm` is the spectral-domain baseline: magnitude in,
``Dense(496, tanh)``, 3 × (BiLSTM(496) + Dropout 0.8), one ReLU mask head per
speaker, each mask multiplied with the input magnitude, heads concatenated on
the feature axis → ``[B, T, num_speakers * output_size]``. ``forward`` serves
(dropout is identity in eval); ``train_forward`` is the differentiable
training forward, whose BiLSTM recurrences run through the training kernels
of ``ops/lstm_train_cuda.py``.

Submodules carry the JAX parameter tree's names (``input_proj``,
``bilstm_{i}.cells``, ``heads.mask_head_{s}``) and layouts (``Dense`` kernels
are ``[in, out]``), so ``weights.upit_blstm_state_dict`` is a pure rename.
The network computes in its parameters' dtype: cast the module (``.to``) to
run it in bf16, as the JAX pipeline casts its parameter tree.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.lstm_train_cuda import bilstm_train
from .blstm import BiLSTM, segment_keeps

__all__ = ["Dense", "UPitBlstm", "dropout"]


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax's layout and init (truncated lecun-normal, zero bias)."""

    def __init__(
        self, in_features: int, out_features: int, *, generator: torch.Generator | None = None
    ):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        # flax lecun_normal: variance 1/fan_in, truncated at ±2 std and rescaled
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, 0.0, std, -2 * std, 2 * std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x.reshape(-1, x.shape[-1]), self.kernel).view(
            *x.shape[:-1], -1
        )


class _MaskHeads(nn.Module):
    """Per-speaker ReLU mask heads applied to the shared trunk output."""

    def __init__(
        self, in_features: int, output_size: int, num_speakers: int, generator=None
    ):
        super().__init__()
        self.num_speakers = num_speakers
        for s in range(num_speakers):
            self.add_module(
                f"mask_head_{s}", Dense(in_features, output_size, generator=generator)
            )

    def forward(self, trunk: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
        outs = [
            torch.relu(getattr(self, f"mask_head_{s}")(trunk)) * mix
            for s in range(self.num_speakers)
        ]
        return torch.cat(outs, dim=-1)


class UPitBlstm(nn.Module):
    """Spectral-magnitude uPIT BLSTM separator."""

    def __init__(
        self,
        input_size: int = 129,
        output_size: int = 129,
        hidden: int = 496,
        num_layers: int = 3,
        num_speakers: int = 2,
        dropout_rate: float = 0.8,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.num_speakers = num_speakers
        self.dropout_rate = dropout_rate
        self.input_proj = Dense(input_size, hidden, generator=generator)
        for i in range(num_layers):
            width = hidden if i == 0 else 2 * hidden
            self.add_module(f"bilstm_{i}", BiLSTM(width, hidden, generator=generator))
        self.heads = _MaskHeads(2 * hidden, output_size, num_speakers, generator=generator)

    def forward(
        self,
        magnitude: torch.Tensor,
        *,
        segment_ids: torch.Tensor | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        """``[B, T, input_size]`` → ``[B, T, num_speakers * output_size]`` in the
        parameters' dtype. ``plain=True`` runs the recurrences' plain loop
        instead of the CUDA kernel (the reference path on a GPU).
        ``segment_ids [B, T]``: sequence-packed rows, each utterance isolated
        (the recurrences then run the training forward kernel in its keep
        mode; serve under ``torch.no_grad``)."""
        x = magnitude.to(self.input_proj.kernel.dtype)
        h = torch.tanh(self.input_proj(x))
        for i in range(self.num_layers):
            h = getattr(self, f"bilstm_{i}")(h, segment_ids, plain=plain)
        return self.heads(h, x)

    def train_forward(
        self,
        magnitude: torch.Tensor,
        *,
        generator: torch.Generator | None = None,
        compute_dtype: torch.dtype | None = None,
        segment_ids: torch.Tensor | None = None,
        plain: bool = False,
    ) -> torch.Tensor:
        """Differentiable training forward (counterpart of
        ``upit_blstm_train_forward``): ``[B, T, input_size]`` → fp32
        ``[B, T, num_speakers * output_size]``.

        The fp32 master parameters are cast to ``compute_dtype`` (default
        fp32) differentiably, so they receive fp32 gradients of the cast. Each
        BiLSTM layer is :func:`~..ops.lstm_train_cuda.bilstm_train`, whose
        forward and backward recurrences are CUDA kernels (their plain loops
        on the CPU or with ``plain=True``). ``generator=None`` disables
        dropout (eval); otherwise dropout at ``dropout_rate`` follows every
        BiLSTM layer, with bits from ``generator``, not JAX's stream.
        ``segment_ids [B, T]`` (sequence-packed rows, ``data/packing.py``)
        runs every recurrence with the carry gate of
        :func:`~.blstm.segment_keeps`, built on the ids' device.
        """
        dtype = compute_dtype or torch.float32
        keep = None if segment_ids is None else segment_keeps(segment_ids)
        p = {name: value.to(dtype) for name, value in self.named_parameters()}

        def dense(prefix: str, x: torch.Tensor) -> torch.Tensor:
            return x @ p[f"{prefix}.kernel"] + p[f"{prefix}.bias"]

        x = magnitude.to(dtype)
        h = torch.tanh(dense("input_proj", x))
        for layer in range(self.num_layers):
            cells = f"bilstm_{layer}.cells"
            h = bilstm_train(
                h,
                p[f"{cells}.kernel"],
                p[f"{cells}.recurrent_kernel"],
                p[f"{cells}.bias"],
                keep=keep,
                compute_dtype=dtype,
                plain=plain,
            ).to(dtype)
            if generator is not None and self.dropout_rate > 0.0:
                h = dropout(h, self.dropout_rate, generator)
        outs = [
            torch.relu(dense(f"heads.mask_head_{s}", h)) * x for s in range(self.num_speakers)
        ]
        return torch.cat(outs, dim=-1).to(torch.float32)


def dropout(h: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Keep each value with probability ``1 - rate``, scaled by ``1 / (1 - rate)``;
    zero the rest (the bits come from ``generator``, on ``h``'s device)."""
    kept = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - rate
    return torch.where(kept, h / (1.0 - rate), 0.0).to(h.dtype)
