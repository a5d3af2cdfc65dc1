"""SepFormer dual-path transformer separator (Subakan, Ravanelli, Cornell,
Bronzi and Zhong, "Attention is All You Need in Speech Separation", ICASSP
2021, arXiv:2010.13154; the equations of SpeechBrain's WSJ0-2mix recipe,
``lobes/models/dual_path.py`` and ``lobes/models/transformer``). The port has
no JAX counterpart.

- encoder: Conv1D(``enc_dim``, kernel ``win``, stride ``win/2``, "SAME", no
  bias), ReLU (``tasnet.encode``);
- front end: gLN (GroupNorm with one group, eps 1e-8), then a 1×1
  ``enc_dim`` → ``d_model`` with no bias;
- segmentation: DPRNN's (:func:`.dprnn.segment`), chunks of ``chunk`` (K)
  frames every K/2;
- ``blocks`` dual-path blocks (DPRNN's scaffold, :class:`.dprnn._DualPathBlock`):
  an intra half over the K frames of every chunk, then an inter half over the
  S chunks at every chunk position; a half is sinusoidal positions (0 .. L−1)
  added to its input, ``layers`` pre-LN transformer layers (x + MHA(LN(x)),
  then x + FFN(LN(x)); ``heads`` heads with biased in- and out-projections,
  FFN Linear ``d_model`` → ``ffn``, ReLU, Linear back; LN eps 1e-6) and a
  final LN, then gLN over the whole item and the residual around the half;
- mask head: PReLU → 1×1 ``d_model`` → ``num_speakers · d_model`` (biased)
  → overlap-add (:func:`.dprnn.overlap_add`) → per speaker tanh(1×1) ⊙
  sigmoid(1×1) → 1×1 ``d_model`` → ``enc_dim`` (no bias) → ReLU: the mask,
  times the encoder's output;
- decoder: ``tasnet.decode`` with no bias, one transposed conv a speaker.

No attention mask: padded frames attend like any other, as gLN sees the
padded item. Departures from SpeechBrain: "SAME" encoder and decoder padding
as the port's DPRNN, and DPRNN's segmentation (S = ⌈T/P⌉ + 1, where
SpeechBrain pads to whole chunks).

Precision: the residual stream, every norm's statistics, the encoder, the
mask product and the decoder are fp32. Each product (every Linear and 1×1
conv, and through them the attention) runs in its weights' dtype:
:func:`serving_fn` with ``bf16`` casts those weights, and the attention then
runs in SDPA's flash kernel on a GPU (``ops/attention.py``; fp32 there is
refused, not served in another backend). Each residual add and the
LayerNorm after it are one call (``ops/layer_norm_cuda.py``), which writes
the normed rows straight in the dtype of the product that reads them; on a
GPU with autograd off it is one hand-written kernel.

Submodules: ``encoder``, ``input_norm``, ``input_proj``,
``dp_{i}.{intra,inter}.layer_{j}.{attn_norm,attn_in,attn_out,ffn_norm,ffn_in,ffn_out}``,
``dp_{i}.{intra,inter}.norm`` (the final LN), ``dp_{i}.{intra,inter}_norm``
(gLN), ``mask_prelu``, ``mask_proj``, ``gate_tanh``, ``gate_sigmoid``,
``mask_out``, ``decoder``, in flax's layouts as ``models/tasnet.py``.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import attention
from ..ops.layer_norm_cuda import residual_layer_norm
from ..utils.profiling import span
from .dprnn import _DualPathBlock, overlap_add, segment
from .tasnet import _Conv, _Norm, _PReLU, decode, encode

__all__ = ["SepFormer", "positional_encoding", "products_in_bf16", "serving_fn"]


def positional_encoding(length: int, channels: int, device=None) -> torch.Tensor:
    """``[length, channels]`` fp32: sin at even channels, cos at odd, at rate
    10000^(−2i/channels) for channel pair i (worked in float64)."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    rate = torch.exp(torch.arange(0, channels, 2, dtype=torch.float64, device=device)
                     * (-math.log(10000.0) / channels))
    pe = torch.empty(length, channels, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * rate)
    pe[:, 1::2] = torch.cos(pos * rate)
    return pe.float()


def _product(conv: _Conv, x: torch.Tensor) -> torch.Tensor:
    """A Linear or 1×1 conv over channels-last ``x`` in its weights' dtype."""
    return conv.pointwise(x.to(conv.kernel.dtype))


class _LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-6, statistics in fp32, fused with
    the residual add before it (``ops/layer_norm_cuda.py``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, y: torch.Tensor | None, out_dtype: torch.dtype):
        """``(x + y, LN(x + y))`` over the fp32 stream ``x`` and a branch
        ``y`` (None: ``(x, LN(x))``), the normed rows in ``out_dtype``."""
        return residual_layer_norm(x, y, self.gamma, self.beta, out_dtype)


class _TransformerLayer(nn.Module):
    """Pre-LN: x + MHA(LN(x)), then x + FFN(LN(x)), over ``x [R, L, d]`` fp32.

    Each residual add is fused with the LayerNorm after it, so the layer
    takes the stream with its ``attn_norm`` rows already made and gives the
    stream with the rows of ``next_norm`` (the next layer's ``attn_norm``, or
    the stack's final norm) in ``next_dtype``."""

    def __init__(self, d_model: int, heads: int, ffn: int, generator):
        super().__init__()
        self.heads = heads
        self.attn_norm = _LayerNorm(d_model)
        self.attn_in = _Conv(1, d_model, 3 * d_model, generator)  # q, k, v
        self.attn_out = _Conv(1, d_model, d_model, generator)
        self.ffn_norm = _LayerNorm(d_model)
        self.ffn_in = _Conv(1, d_model, ffn, generator)
        self.ffn_out = _Conv(1, ffn, d_model, generator)

    def forward(self, x: torch.Tensor, h: torch.Tensor, next_norm: _LayerNorm,
                next_dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        r, length, d = x.shape
        qkv = _product(self.attn_in, h).view(r, length, 3, self.heads, d // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # each [R, heads, L, d / heads]
        y = attention(q, k, v).transpose(1, 2).reshape(r, length, d)
        x, h = self.ffn_norm(x, _product(self.attn_out, y), self.ffn_in.kernel.dtype)
        h = torch.relu(_product(self.ffn_in, h))
        return next_norm(x, _product(self.ffn_out, h), next_dtype)


class _TransformerStack(nn.Module):
    """One half's transformer: positions added, ``layers`` layers, a final LN."""

    def __init__(self, d_model: int, heads: int, ffn: int, layers: int, generator):
        super().__init__()
        self.layers = layers
        for j in range(layers):
            self.add_module(f"layer_{j}", _TransformerLayer(d_model, heads, ffn, generator))
        self.norm = _LayerNorm(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [R, L, d] → fp32 [R, L, d]
        x = x.float() + positional_encoding(x.shape[1], x.shape[2], x.device)
        layers = [getattr(self, f"layer_{j}") for j in range(self.layers)]
        # each LN's rows in the dtype of what reads them: an in-projection's
        # weights, or (the final norm) gLN's fp32
        norms = [(layer.attn_norm, layer.attn_in.kernel.dtype) for layer in layers]
        norms.append((self.norm, torch.float32))
        norm, dtype = norms[0]
        x, h = norm(x, None, dtype)
        for layer, (norm, dtype) in zip(layers, norms[1:]):
            x, h = layer(x, h, norm, dtype)
        return h


class _TransformerBlock(_DualPathBlock):
    """SepFormer's block: each half a transformer stack."""

    spans = ("sepformer.intra", "sepformer.inter")

    def __init__(self, d_model: int, heads: int, ffn: int, layers: int, generator):
        super().__init__()
        for part in ("intra", "inter"):
            self.add_module(part, _TransformerStack(d_model, heads, ffn, layers, generator))
            self.add_module(f"{part}_norm", _Norm(d_model))

    def half(self, part: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, part)(x)


class SepFormer(nn.Module):
    def __init__(
        self,
        num_speakers: int = 2,
        enc_dim: int = 256,
        win: int = 16,
        d_model: int = 256,
        heads: int = 8,
        ffn: int = 1024,
        layers: int = 8,
        chunk: int = 250,
        blocks: int = 2,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if chunk < 2 or chunk % 2:
            raise ValueError(f"SepFormer: chunks overlap by half, so chunk must be even, got {chunk}")
        if heads < 1 or d_model % heads:
            raise ValueError(f"SepFormer: {heads} heads do not divide d_model = {d_model}")
        if d_model % 2:
            raise ValueError(f"SepFormer: the sinusoidal positions need an even d_model, got {d_model}")
        self.num_speakers, self.enc_dim, self.win = num_speakers, enc_dim, win
        self.d_model, self.chunk, self.hop, self.blocks = d_model, chunk, chunk // 2, blocks
        self.encoder = _Conv(win, 1, enc_dim, generator, bias=False)
        self.input_norm = _Norm(enc_dim)
        self.input_proj = _Conv(1, enc_dim, d_model, generator, bias=False)
        for i in range(blocks):
            self.add_module(f"dp_{i}", _TransformerBlock(d_model, heads, ffn, layers, generator))
        self.mask_prelu = _PReLU()
        self.mask_proj = _Conv(1, d_model, num_speakers * d_model, generator)
        self.gate_tanh = _Conv(1, d_model, d_model, generator)
        self.gate_sigmoid = _Conv(1, d_model, d_model, generator)
        self.mask_out = _Conv(1, d_model, enc_dim, generator, bias=False)
        self.decoder = _Conv(win, enc_dim, 1, generator, bias=False)

    @property
    def stride(self) -> int:
        return self.win // 2

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """``mix``: ``[B, samples]`` (a multiple of ``win // 2``) → fp32 ``[B, S, samples]``."""
        b, samples = mix.shape
        if samples % self.stride:
            raise ValueError(f"pad waveforms to a multiple of win//2 = {self.stride}, got {samples}")
        with span("sepformer.encode", device=True):
            extra = (self.win - self.stride) % 2  # "SAME" puts an odd pad on the right
            feats = encode(F.pad(mix, (0, extra)), self.encoder.kernel, None, self.win).float()
            frames = feats.shape[1]
            h = _product(self.input_proj, self.input_norm(feats))
            h = segment(h.float(), self.hop)
        for i in range(self.blocks):
            h = getattr(self, f"dp_{i}")(h)
        with span("sepformer.decode", device=True):
            y = overlap_add(_product(self.mask_proj, self.mask_prelu(h)).float(), frames)
            y = y.view(b, frames, self.num_speakers, self.d_model)
            gated = torch.tanh(_product(self.gate_tanh, y)) * torch.sigmoid(_product(self.gate_sigmoid, y))
            masks = torch.relu(_product(self.mask_out, gated)).float()
            masked = masks * feats[:, :, None, :]
            masked = masked.transpose(1, 2).reshape(b * self.num_speakers, frames, self.enc_dim)
            wav = decode(masked.to(self.decoder.kernel.dtype), self.decoder.kernel, None, self.win)
            return wav.reshape(b, self.num_speakers, -1).float()[:, :, :samples]


def products_in_bf16(model: SepFormer) -> SepFormer:
    """A copy of ``model`` whose products' weights (every Linear and 1×1
    conv, not the encoder or the decoder) are bf16; norms stay fp32."""
    net = copy.deepcopy(model)
    for name, module in net.named_modules():
        if isinstance(module, _Conv) and name not in ("encoder", "decoder"):
            module.to(torch.bfloat16)
    return net


def serving_fn(model: SepFormer, *, bf16: bool = False):
    """``serve(mix [B, samples]) -> fp32 [B, S, samples]`` under inference
    mode: the module's forward, on :func:`products_in_bf16`'s copy where
    ``bf16``, so the attention runs in the flash kernel on a GPU. ``cli
    separate`` serves a ``sepformer`` checkpoint through it."""
    net = (products_in_bf16(model) if bf16 else model).eval()

    @torch.inference_mode()
    def serve(mix: torch.Tensor) -> torch.Tensor:
        return net(mix)

    return serve
