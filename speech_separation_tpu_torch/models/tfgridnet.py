"""TF-GridNet time-frequency separator (Z.-Q. Wang, S. Cornell, S. Choi, Y. Lee,
B.-Y. Kim and S. Watanabe, "TF-GridNet: Integrating Full- and Sub-Band
Modeling for Speech Separation", IEEE/ACM TASLP 2023, arXiv:2211.12433; the
equations of ESPnet's ``espnet2/enh/separator/tfgridnet_separator.py``). The
port has no JAX counterpart.

- the mixture divided by its standard deviation (over the padded item);
- STFT (``n_fft`` samples, hop ``hop``, square-root Hann; ``ops/stft_cuda.py``)
  → (real, imag) ``[B, T, F, 2]`` → Conv2d(2 → D, 3×3, padding 1) →
  GroupNorm(1, D);
- ``blocks`` grid blocks over the channels-last stream ``x [B, T, F, D]``:

  1. intra-frame: LN over D at each (t, f), the F axis unfolded by windows of
     ``kernel`` (I) bins at stride 1 into ``[B·T, F − I + 1, I·D]`` (feature
     ``k·D + c`` is bin ``p + k``, channel ``c``), BiLSTM(I·D → ``hidden``
     a direction), ConvTranspose1d(2·hidden → D, I) back to F bins, plus x;
  2. sub-band: the same over T at each frequency (rows ``B·F``);
  3. full-band self-attention across frames: for each of ``heads`` heads,
     Q and K = LN₍E,F₎(PReLU(1×1 D → E)) and V = LN₍D/heads,F₎(PReLU(1×1 D →
     D/heads)), each flattened per frame to rows of E·F and D/heads·F
     values, softmax(Q Kᵀ / √(E·F)) V; the heads concatenated, then
     LN₍D,F₎(PReLU(1×1 D → D)), plus x. E = ⌈``qk_dim`` / F⌉; the LN₍C,F₎
     normalise over the C channels and F bins of a frame (ESPnet's
     ``LayerNormalization4DCF``), with a scale and shift a (channel, bin);
- ConvTranspose2d(D → 2·speakers, 3×3, padding 1): each speaker's (real,
  imag) spectrum → iSTFT → times the standard deviation.

Every norm has eps ``eps``; each PReLU one slope (a head, in the attention's
projections). The BiLSTMs are ``models/blstm.py::BiLSTM``, so with gradients
off their recurrences run in the serving kernel (kernel table row 2); each
residual add and the LN over D after it are one call of
``ops/layer_norm_cuda.py`` (one hand-written kernel on a GPU with autograd
off, which writes the normed rows in the BiLSTM's dtype); the attention runs
in ``ops/wide_attention_cuda.py`` (its probabilities in a hand-written
kernel on a GPU, bf16 only). Departures from ESPnet: the STFT pads
``n_fft − hop`` zeros a side (the port's fading) where ESPnet's ``torch.stft``
centres with reflected pads; one LSTM bias a gate (Keras's layout); the
standard deviation and GroupNorm see the padded item; no attention mask.

Precision: the residual stream, every norm's statistics, the encoder conv,
the decoder and the STFT and iSTFT are fp32. Each product (the BiLSTMs'
input projections and recurrences, the transposed 1-D convs, every 1×1 and
the attention) runs in its weights' dtype: :func:`serving_fn` with ``bf16``
casts those weights (:func:`products_in_bf16`).

Submodules: ``conv`` (kernel ``[3, 3, 2, D]``), ``conv_norm``,
``block_{i}.{intra,inter}_norm``, ``block_{i}.{intra,inter}_rnn``,
``block_{i}.{intra,inter}_linear`` (kernel ``[I, 2·hidden, D]``: tap, in,
out), ``block_{i}.attn_{q,k,v,proj}`` (``conv``, ``alpha``, ``gamma`` and
``beta`` ``[heads, width, F]``), ``deconv`` (kernel ``[3, 3, D,
2·speakers]``).
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layer_norm_cuda import residual_layer_norm
from ..ops.stft import istft
from ..ops.stft_cuda import stft_cuda
from ..ops.wide_attention_cuda import wide_attention
from ..utils.profiling import span
from .blstm import BiLSTM
from .tasnet import _Conv, _lecun_normal_

__all__ = ["TFGridNet", "products_in_bf16", "serving_fn"]


class _Conv2d(nn.Module):
    """A 3×3 convolution's parameters, ``kernel [3, 3, in, out]`` and ``bias [out]``."""

    def __init__(self, c_in: int, c_out: int, generator):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, c_in, c_out))
        self.bias = nn.Parameter(torch.zeros(c_out))
        _lecun_normal_(self.kernel, 9 * c_in, generator)

    def conv(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, F, in]`` → ``[B, T, F, out]``, padding 1, in channels-last memory."""
        y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.permute(3, 2, 0, 1), self.bias, padding=1)
        return y.permute(0, 2, 3, 1).contiguous()

    def conv_transpose(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, F, in]`` → ``[B, out, T, F]``: ConvTranspose2d, padding 1."""
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), self.kernel.permute(2, 3, 0, 1),
                                  self.bias, padding=1)


class _ChannelNorm(nn.Module):
    """ESPnet's ``LayerNormalization4D``: LN over the channels of each (t, f)."""

    def __init__(self, channels: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))


class _Projection(nn.Module):
    """1×1 D → heads·width, PReLU (a slope a head), then LN over the
    (width, F) plane of each head and frame, fp32 statistics."""

    def __init__(self, d_model: int, heads: int, width: int, freqs: int, eps: float, generator):
        super().__init__()
        self.heads, self.width, self.eps = heads, width, eps
        self.conv = _Conv(1, d_model, heads * width, generator)
        self.alpha = nn.Parameter(torch.full((heads,), 0.25))
        self.gamma = nn.Parameter(torch.ones(heads, width, freqs))
        self.beta = nn.Parameter(torch.zeros(heads, width, freqs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, F, D]`` → fp32 ``[B, T, F, heads, width]``."""
        b, t, f, _ = x.shape
        y = self.conv.pointwise(x.to(self.conv.kernel.dtype)).float()
        y = y.view(b, t, f, self.heads, self.width)
        y = torch.where(y >= 0, y, self.alpha[:, None] * y)
        mean = y.mean(dim=(2, 4), keepdim=True)
        var = (y - mean).square().mean(dim=(2, 4), keepdim=True)
        gamma, beta = self.gamma.permute(2, 0, 1), self.beta.permute(2, 0, 1)  # [F, heads, width]
        return (y - mean) * torch.rsqrt(var + self.eps) * gamma + beta


def _taps(conv: _Conv, y: torch.Tensor) -> torch.Tensor:
    """The products of a transposed 1-D conv of ``kernel [I, in, out]``:
    ``[..., P, in]`` → ``[..., P, I, out]`` in the kernel's dtype; output
    position ``q`` sums ``[..., q − k, k, :]`` over the taps k."""
    taps, c_in, c_out = conv.kernel.shape
    w = conv.kernel.permute(1, 0, 2).reshape(c_in, taps * c_out)
    z = y.to(w.dtype).reshape(-1, c_in) @ w
    return z.view(*y.shape[:-1], taps, c_out)


def _windows(h: torch.Tensor, size: tuple, stride: tuple) -> torch.Tensor:
    """The unfolded rows of the contiguous ``h``: a strided view copied once."""
    return h.as_strided(size, stride, h.storage_offset()).contiguous()


class _GridBlock(nn.Module):
    """One TF-GridNet block's modules and its three parts over ``[B, T, F, D]``."""

    def __init__(self, d_model: int, kernel: int, hidden: int, heads: int, qk_width: int,
                 freqs: int, eps: float, generator):
        super().__init__()
        self.kernel = kernel
        for part in ("intra", "inter"):
            self.add_module(f"{part}_norm", _ChannelNorm(d_model))
            self.add_module(f"{part}_rnn", BiLSTM(kernel * d_model, hidden, generator=generator))
            self.add_module(f"{part}_linear", _Conv(kernel, 2 * hidden, d_model, generator))
        self.attn_q = _Projection(d_model, heads, qk_width, freqs, eps, generator)
        self.attn_k = _Projection(d_model, heads, qk_width, freqs, eps, generator)
        self.attn_v = _Projection(d_model, heads, d_model // heads, freqs, eps, generator)
        self.attn_proj = _Projection(d_model, 1, d_model, freqs, eps, generator)

    def intra(self, h: torch.Tensor) -> torch.Tensor:
        """The intra-frame branch of the normed stream ``h``: fp32 ``[B, T, F, D]``."""
        b, t, f, d = h.shape
        k, p = self.kernel, f - self.kernel + 1
        rows = _windows(h, (b * t, p, k, d), (f * d, d, d, 1)).view(b * t, p, k * d)
        z = _taps(self.intra_linear, self.intra_rnn(rows))  # [B·T, P, I, D]
        out = self.intra_linear.bias.float().expand(b * t, f, d).contiguous()
        for tap in range(k):
            out[:, tap:tap + p] += z[:, :, tap]
        return out.view(b, t, f, d)

    def inter(self, h: torch.Tensor) -> torch.Tensor:
        """The sub-band branch of the normed stream ``h``: fp32 ``[B, T, F, D]``."""
        b, t, f, d = h.shape
        k, p = self.kernel, t - self.kernel + 1
        rows = _windows(h, (b, f, p, k, d), (t * f * d, d, f * d, f * d, 1)).view(b * f, p, k * d)
        z = _taps(self.inter_linear, self.inter_rnn(rows)).view(b, f, p, k, d)
        out = self.inter_linear.bias.float().expand(b, t, f, d).contiguous()
        for tap in range(k):
            out[:, tap:tap + p] += z[:, :, :, tap].transpose(1, 2)
        return out

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        """The full-band attention branch of the stream ``x``: fp32 ``[B, T, F, D]``."""
        b, t, f, d = x.shape
        heads = self.attn_q.heads
        dtype = self.attn_q.conv.kernel.dtype

        def rows(proj: _Projection) -> torch.Tensor:  # [heads·B, T, F·width]
            y = proj(x).permute(3, 0, 1, 2, 4)
            return y.to(dtype).reshape(heads * b, t, f * proj.width)

        o = wide_attention(rows(self.attn_q), rows(self.attn_k), rows(self.attn_v))
        o = o.view(heads, b, t, f, d // heads).permute(1, 2, 3, 0, 4).reshape(b, t, f, d)
        return self.attn_proj(o).view(b, t, f, d)


class TFGridNet(nn.Module):
    def __init__(
        self,
        num_speakers: int = 2,
        n_fft: int = 256,
        hop: int = 64,
        d_model: int = 128,
        blocks: int = 4,
        kernel: int = 4,
        hidden: int = 256,
        heads: int = 4,
        qk_dim: int = 512,
        eps: float = 1e-5,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if heads < 1 or d_model % heads:
            raise ValueError(f"TFGridNet: {heads} heads do not divide d_model = {d_model}")
        freqs = n_fft // 2 + 1
        if kernel < 1 or kernel > freqs:
            raise ValueError(f"TFGridNet: an unfold kernel of {kernel} over {freqs} bins")
        self.num_speakers, self.n_fft, self.hop = num_speakers, n_fft, hop
        self.d_model, self.blocks, self.kernel, self.eps = d_model, blocks, kernel, eps
        self.freqs, self.qk_width = freqs, -(-qk_dim // freqs)
        self.conv = _Conv2d(2, d_model, generator)
        self.conv_norm = _ChannelNorm(d_model)
        for i in range(blocks):
            self.add_module(f"block_{i}", _GridBlock(d_model, kernel, hidden, heads, self.qk_width,
                                                     freqs, eps, generator))
        self.deconv = _Conv2d(d_model, 2 * num_speakers, generator)

    def _add_norm(self, x: torch.Tensor, y: torch.Tensor | None, norm: _ChannelNorm,
                  rnn: BiLSTM):
        """``(x + y, LN(x + y))`` in one fused call, the rows in the dtype of
        the BiLSTM that reads them."""
        return residual_layer_norm(x, y, norm.gamma, norm.beta, rnn.cells.kernel.dtype, self.eps)

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """``mix``: ``[B, samples]`` → fp32 ``[B, speakers, samples]``."""
        b, samples = mix.shape
        if samples < 2:
            raise ValueError(f"TFGridNet: a mixture of {samples} samples has no deviation")
        blocks = [getattr(self, f"block_{i}") for i in range(self.blocks)]
        with span("tfgridnet.encode", device=True):
            mix = mix.float()
            std = mix.std(dim=1, keepdim=True)
            spec = stft_cuda(mix / std, self.n_fft, self.hop, window="sqrt_hann")
            x = self.conv.conv(torch.view_as_real(spec))  # [B, T, F, D]
            t = x.shape[1]
            if t < self.kernel:
                raise ValueError(f"TFGridNet: {t} frames, fewer than the unfold kernel {self.kernel}")
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * torch.rsqrt(var + self.eps) * self.conv_norm.gamma + self.conv_norm.beta
        if blocks:
            x, h = self._add_norm(x, None, blocks[0].intra_norm, blocks[0].intra_rnn)
        for i, block in enumerate(blocks):
            with span("tfgridnet.intra", device=True):
                x, h = self._add_norm(x, block.intra(h), block.inter_norm, block.inter_rnn)
            with span("tfgridnet.inter", device=True):
                x = x + block.inter(h)
            with span("tfgridnet.attention", device=True):
                if i + 1 < len(blocks):  # the residual and the next block's first norm
                    after = blocks[i + 1]
                    x, h = self._add_norm(x, block.attention(x), after.intra_norm, after.intra_rnn)
                else:
                    x = x + block.attention(x)
        with span("tfgridnet.decode", device=True):
            y = self.deconv.conv_transpose(x)  # [B, 2·speakers, T, F]
            y = y.reshape(b * self.num_speakers, 2, t, self.freqs)
            wav = istft(torch.complex(y[:, 0], y[:, 1]), self.n_fft, self.hop, window="sqrt_hann")
            return wav[:, :samples].reshape(b, self.num_speakers, samples) * std[:, :, None]


def products_in_bf16(model: TFGridNet) -> TFGridNet:
    """A copy of ``model`` whose products' weights (the BiLSTMs, the
    transposed 1-D convs, every 1×1) are bf16; the encoder conv, the decoder,
    the norms and the PReLU slopes stay fp32."""
    net = copy.deepcopy(model)
    for module in net.modules():
        if isinstance(module, (_Conv, BiLSTM)):
            module.to(torch.bfloat16)
    return net


def serving_fn(model: TFGridNet, *, bf16: bool = False):
    """``serve(mix [B, samples]) -> fp32 [B, S, samples]`` under inference
    mode: the module's forward, on :func:`products_in_bf16`'s copy where
    ``bf16``, so the attention runs in the wide-head kernel on a GPU (which
    takes bf16 only). ``cli separate`` serves a ``tfgridnet`` checkpoint
    through it."""
    net = (products_in_bf16(model) if bf16 else model).eval()

    @torch.inference_mode()
    def serve(mix: torch.Tensor) -> torch.Tensor:
        return net(mix)

    return serve
