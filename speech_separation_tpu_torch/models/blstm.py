"""LSTM / bidirectional LSTM layers (counterpart of ``models/blstm.py``).

Parameters keep the JAX package's Keras layout: ``kernel [F, 4H]``,
``recurrent_kernel [H, 4H]``, one ``bias [4H]`` whose forget slice starts at
1, gate order i, f, g, o. Initialisation is Keras's: glorot-uniform input
kernel, orthogonal recurrent kernel, drawn from an explicit
``torch.Generator``.

The input projection ``x @ W + b`` of every timestep is one ``torch.matmul``;
the recurrence runs in ``ops/lstm_cuda.py`` (the CUDA kernel on a GPU tensor,
its plain loop on the CPU, or the plain loop anywhere with ``plain=True``).

Like the JAX layers, padded timesteps are processed as ordinary inputs, and
the backward direction runs over the whole padded length. :func:`segment_keep`
builds the carry gate of sequence-packed rows for the training recurrence.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.lstm_cuda import lstm_recurrence, lstm_recurrence_plain

__all__ = ["LSTM", "BiLSTM", "segment_keep"]


def segment_keep(segment_ids: torch.Tensor) -> torch.Tensor:
    """Per-step carry-keep gate for a forward-time scan: ``keep[b, t] = 1``
    iff frame ``t`` continues frame ``t-1``'s segment (``keep[:, 0] = 1``;
    the zero initial carry handles the row start). Float32 ``[B, T]``."""
    same = segment_ids[:, 1:] == segment_ids[:, :-1]
    first = torch.ones_like(same[:, :1])
    return torch.cat([first, same], dim=1).to(torch.float32)


class LSTM(nn.Module):
    """LSTM over ``[batch, time, features]`` returning every hidden state.

    ``directions=1`` has Keras's parameter shapes. ``directions=2`` stacks a
    leading direction axis of 2 on every parameter, like the JAX BiLSTM's
    ``nn.vmap``-ed ``cells``; direction 1 runs backwards in time, and the
    output is ``[B, T, 2H]``.
    """

    def __init__(
        self,
        input_size: int,
        features: int,
        *,
        directions: int = 1,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.features = features
        self.directions = directions
        lead = () if directions == 1 else (directions,)
        h4 = 4 * features
        self.kernel = nn.Parameter(torch.empty(*lead, input_size, h4))
        self.recurrent_kernel = nn.Parameter(torch.empty(*lead, features, h4))
        self.bias = nn.Parameter(torch.zeros(*lead, h4))
        with torch.no_grad():
            kernels = self.kernel.view(-1, input_size, h4)
            recurrents = self.recurrent_kernel.view(-1, features, h4)
            for d in range(directions):
                nn.init.xavier_uniform_(kernels[d], generator=generator)
                nn.init.orthogonal_(recurrents[d], generator=generator)
            self.bias[..., features : 2 * features] = 1.0

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        b, t, f = x.shape
        dirs, h4 = self.directions, 4 * self.features
        # one GEMM per direction over every timestep, bias fused: [D, B, T, 4H]
        xw = torch.baddbmm(
            self.bias.view(dirs, 1, h4),
            x.reshape(1, b * t, f).expand(dirs, -1, -1),
            self.kernel.view(dirs, f, h4),
        ).view(dirs, b, t, h4)
        recurrent = self.recurrent_kernel.view(dirs, self.features, h4)
        run = lstm_recurrence_plain if plain else lstm_recurrence
        return run(xw, recurrent, reverse=tuple(d == 1 for d in range(dirs)))


class BiLSTM(nn.Module):
    """Bidirectional LSTM with concatenated outputs: ``[B, T, 2 * features]``."""

    def __init__(
        self, input_size: int, features: int, *, generator: torch.Generator | None = None
    ):
        super().__init__()
        self.cells = LSTM(input_size, features, directions=2, generator=generator)

    def forward(self, x: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
        return self.cells(x, plain=plain)
