"""DPRNN-TasNet dual-path BLSTM separator (Luo, Chen and Yoshioka, "Dual-path
RNN: efficient long sequence modeling for time-domain single-channel speech
separation", ICASSP 2020, arXiv:1910.06379). The port has no JAX counterpart.

- encoder: Conv1D(``enc_dim``, kernel ``win``, stride ``win/2``, "SAME"),
  ReLU (``tasnet.encode``);
- front end: gLN, then a 1×1 bottleneck ``enc_dim`` → ``bottleneck`` (N);
- segmentation: ``[B, T, N]`` → ``[B, S, K, N]``, chunks of ``chunk`` (K,
  even) frames every P = K/2 frames, with K − P zeros in front and as
  many behind as put every frame in exactly two chunks (:func:`segment`);
- ``blocks`` dual-path blocks, each an intra half over the K frames of every
  chunk (rows ``B·S``) and then an inter half over the S chunks at every
  chunk position (rows ``B·K``); a half is BiLSTM(N, ``hidden``) →
  Linear(2·hidden → N) → gLN over the whole item → plus the half's input;
- mask head: PReLU → 1×1 N → ``num_speakers · enc_dim`` → overlap-add back
  to the sequence (:func:`overlap_add`) → sigmoid, times the encoder's
  features;
- decoder: ``tasnet.decode``, one shared transposed conv a speaker.

The BiLSTMs are ``models/blstm.py::BiLSTM``, which chooses the recurrence:
the serving kernel (kernel table row 2) with gradients off, the training
kernels (rows 3 and 4) with them on. A width that the kernels'
launch plans cannot take is refused by the plan's own ``ValueError``; there
is no fallback.

Departures from the paper: the encoder and decoder pad "SAME" as the port's
Conv-TasNet does; each LSTM has one bias a gate (Keras's layout); gLN sees the
padded item, zeros past an utterance's end included, as in Conv-TasNet's
serving; the mask is a sigmoid (the paper fixes none).

SepFormer (``models/sepformer.py``) shares the chunking, the overlap-add and
the block's scaffold (:class:`_DualPathBlock`: half, gLN, residual).

Submodules: ``encoder``, ``input_norm``, ``input_proj``,
``dp_{i}.{intra,inter}_{rnn,proj,norm}``, ``mask_prelu``, ``mask_proj``,
``decoder``, with Conv-TasNet's flax layouts. Tensors are channels-last; the
network computes in its parameters' dtype (cast the module with ``.to``),
the norms' statistics in fp32.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import span
from .blstm import BiLSTM
from .tasnet import _Conv, _Norm, _PReLU, decode, encode

__all__ = ["DPRNN", "chunks_of", "overlap_add", "segment", "serving_fn"]


def chunks_of(frames: int, hop: int) -> int:
    """S, the chunks of :func:`segment` over ``frames`` frames: every frame
    in two chunks of ``2 · hop`` frames, the first starting ``hop`` frames
    before frame 0."""
    return -(-frames // hop) + 1


def segment(x: torch.Tensor, hop: int) -> torch.Tensor:
    """``[B, T, N]`` → ``[B, S, 2·hop, N]``: chunks of ``2·hop`` frames every
    ``hop``, ``hop`` zeros in front and the rest of the last chunk behind."""
    b, t, n = x.shape
    s = chunks_of(t, hop)
    halves = F.pad(x, (0, 0, hop, (s + 1) * hop - hop - t)).view(b, s + 1, hop, n)
    return torch.cat([halves[:, :-1], halves[:, 1:]], dim=2)


def overlap_add(y: torch.Tensor, frames: int) -> torch.Tensor:
    """The adjoint of :func:`segment`: ``[B, S, 2·hop, C]`` → ``[B, frames,
    C]``, each frame the sum of its two chunks' values."""
    b, s, k, c = y.shape
    hop = k // 2
    halves = F.pad(y[:, :, :hop], (0, 0, 0, 0, 0, 1)) + F.pad(y[:, :, hop:], (0, 0, 0, 0, 1, 0))
    return halves.reshape(b, (s + 1) * hop, c)[:, hop : hop + frames]


class _DualPathBlock(nn.Module):
    """The dual-path scaffold over ``x [B, S, K, N]``: the intra half over the
    K frames of every chunk (rows ``B·S``), then the inter half over the S
    chunks at every chunk position (rows ``B·K``), each followed by gLN over
    the whole item (``{part}_norm``) and the residual. A subclass registers
    each half's modules and the two norms, gives :meth:`half`, and names the
    two profiler spans in ``spans``."""

    spans: tuple[str, str]

    def half(self, part: str, x: torch.Tensor) -> torch.Tensor:
        """One half over rows ``x [R, L, N]`` → ``[R, L, N]``."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, S, K, N]
        b, s, k, n = x.shape
        with span(self.spans[0], device=True):
            y = self.half("intra", x.reshape(b * s, k, n))
            x = x + self.intra_norm(y.view(b, s * k, n)).view(b, s, k, n)
        with span(self.spans[1], device=True):
            y = self.half("inter", x.transpose(1, 2).reshape(b * k, s, n))
            y = self.inter_norm(y.view(b, k * s, n)).view(b, k, s, n)
            x = x + y.transpose(1, 2)
        return x


class _RecurrentBlock(_DualPathBlock):
    """DPRNN's block: each half a BiLSTM and a Linear(2·hidden → N)."""

    spans = ("dprnn.intra", "dprnn.inter")

    def __init__(self, channels: int, hidden: int, generator):
        super().__init__()
        for part in ("intra", "inter"):
            self.add_module(f"{part}_rnn", BiLSTM(channels, hidden, generator=generator))
            self.add_module(f"{part}_proj", _Conv(1, 2 * hidden, channels, generator))
            self.add_module(f"{part}_norm", _Norm(channels))

    def half(self, part: str, x: torch.Tensor) -> torch.Tensor:
        y = getattr(self, f"{part}_rnn")(x)
        return getattr(self, f"{part}_proj").pointwise(y)


class DPRNN(nn.Module):
    def __init__(
        self,
        num_speakers: int = 2,
        enc_dim: int = 64,
        win: int = 2,
        bottleneck: int = 64,
        hidden: int = 128,
        chunk: int = 250,
        blocks: int = 6,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if chunk < 2 or chunk % 2:
            raise ValueError(f"DPRNN: chunks overlap by half, so chunk must be even, got {chunk}")
        self.num_speakers, self.enc_dim, self.win = num_speakers, enc_dim, win
        self.bottleneck, self.hidden = bottleneck, hidden
        self.chunk, self.hop, self.blocks = chunk, chunk // 2, blocks
        self.encoder = _Conv(win, 1, enc_dim, generator)
        self.input_norm = _Norm(enc_dim)
        self.input_proj = _Conv(1, enc_dim, bottleneck, generator)
        for i in range(blocks):
            self.add_module(f"dp_{i}", _RecurrentBlock(bottleneck, hidden, generator))
        self.mask_prelu = _PReLU()
        self.mask_proj = _Conv(1, bottleneck, num_speakers * enc_dim, generator)
        self.decoder = _Conv(win, enc_dim, 1, generator)

    @property
    def stride(self) -> int:
        return self.win // 2

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """``mix``: ``[B, samples]`` (a multiple of ``win // 2``) → fp32 ``[B, S, samples]``."""
        b, samples = mix.shape
        if samples % self.stride:
            raise ValueError(f"pad waveforms to a multiple of win//2 = {self.stride}, got {samples}")
        with span("dprnn.encode", device=True):
            # encode pads (win - stride) // 2 a side; "SAME" puts an odd one on the right
            extra = (self.win - self.stride) % 2
            feats = encode(F.pad(mix, (0, extra)), self.encoder.kernel, self.encoder.bias, self.win)
            frames = feats.shape[1]
            h = self.input_proj.pointwise(self.input_norm(feats))
            h = segment(h, self.hop)
        for i in range(self.blocks):
            h = getattr(self, f"dp_{i}")(h)
        with span("dprnn.decode", device=True):
            masks = torch.sigmoid(overlap_add(self.mask_proj.pointwise(self.mask_prelu(h)), frames))
            masked = masks.view(b, frames, self.num_speakers, self.enc_dim) * feats[:, :, None, :]
            masked = masked.transpose(1, 2).reshape(b * self.num_speakers, frames, self.enc_dim)
            wav = decode(masked, self.decoder.kernel, self.decoder.bias, self.win)
            return wav.reshape(b, self.num_speakers, -1).float()[:, :, :samples]


def serving_fn(model: DPRNN, *, bf16: bool = False):
    """``serve(mix [B, samples]) -> fp32 [B, S, samples]`` under inference
    mode: the module's forward (its recurrences in the serving kernel on a
    GPU), on a bf16 copy of the module where ``bf16`` (norm statistics fp32).
    ``cli separate`` serves a ``dprnn`` checkpoint through it."""
    net = (copy.deepcopy(model).to(torch.bfloat16) if bf16 else model).eval()

    @torch.inference_mode()
    def serve(mix: torch.Tensor) -> torch.Tensor:
        return net(mix)

    return serve
