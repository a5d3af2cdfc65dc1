"""uPIT BLSTM mask-estimation separator (counterpart of ``models/upit.py``).

:class:`UPitBlstm` is the spectral-domain baseline: magnitude in,
``Dense(496, tanh)``, 3 × (BiLSTM(496) + Dropout 0.8), one ReLU mask head per
speaker, each mask multiplied with the input magnitude, heads concatenated on
the feature axis → ``[B, T, num_speakers * output_size]``. Serving only:
dropout is identity in eval, and training (with dropout) is a later slice.

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

from .blstm import BiLSTM

__all__ = ["Dense", "UPitBlstm"]


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
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.input_proj = Dense(input_size, hidden, generator=generator)
        for i in range(num_layers):
            width = hidden if i == 0 else 2 * hidden
            self.add_module(f"bilstm_{i}", BiLSTM(width, hidden, generator=generator))
        self.heads = _MaskHeads(2 * hidden, output_size, num_speakers, generator=generator)

    def forward(self, magnitude: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        """``[B, T, input_size]`` → ``[B, T, num_speakers * output_size]`` in the
        parameters' dtype. ``plain=True`` runs the recurrences' plain loop
        instead of the CUDA kernel (the reference path on a GPU)."""
        x = magnitude.to(self.input_proj.kernel.dtype)
        h = torch.tanh(self.input_proj(x))
        for i in range(self.num_layers):
            h = getattr(self, f"bilstm_{i}")(h, plain=plain)
        return self.heads(h, x)
