"""Conv-TasNet fully-convolutional separator (counterpart of ``models/tasnet.py``).

Structure (Luo & Mesgarani, arXiv:1809.07454):

- encoder: Conv1D(``enc_dim``, kernel ``win``, stride ``win/2``, "SAME"), ReLU;
- separator: gLN → 1×1 bottleneck → ``repeats`` × ``blocks`` dilated blocks
  (1×1 expand → PReLU → gLN → depthwise dilated conv → PReLU → gLN → 1×1
  res and skip), the skips summed;
- masks: PReLU → 1×1 to ``num_speakers × enc_dim`` → sigmoid, times the
  encoder features;
- decoder: one shared transposed conv back to the waveform per speaker.

``causal=True`` swaps gLN for cLN (statistics over the past frames only) and
left-pads the depthwise convs.

Submodules carry the flax names (``encoder``, ``input_norm``, ``input_proj``,
``tcn_{r}_{x}.{expand,prelu1,norm1,depthwise,prelu2,norm2,res_out,skip_out}``,
``mask_prelu``, ``mask_proj``, ``decoder``) and layouts (Conv kernels
``[width, in/groups, out]``, ConvTranspose ``[win, in, out]``, PReLU alpha
``[1]``), so ``weights.convtasnet_state_dict`` is a rename; ``forward``
converts the layouts. Tensors are channels-last ``[B, T, C]`` as in flax. The
network computes in its parameters' dtype (cast the module with ``.to``);
the norms' statistics are always fp32, in one pass.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ConvTasNet",
    "conv_same",
    "conv_same_pads",
    "conv_transpose_pads",
    "conv_transpose_same",
    "encode",
    "decode",
    "depthwise",
]

_EPS = 1e-8


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator) -> None:
    """flax's ``lecun_normal``: variance 1/fan_in, truncated at ±2 std and rescaled."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def conv_same_pads(length: int, width: int, stride: int) -> tuple[int, int]:
    """``(left, right)`` zero padding of ``lax.conv(..., padding="SAME")``:
    ``ceil(length / stride)`` outputs, the padding's odd sample on the right
    (width 4: ``(1, 2)`` at stride 1, ``(1, 1)`` at stride 2 on an even length)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + width - length, 0)
    return total // 2, total - total // 2


def conv_transpose_pads(width: int, stride: int) -> tuple[int, int]:
    """``(left, right)`` padding of the stride-dilated input in
    ``lax.conv_transpose(..., padding="SAME")``, which then correlates with
    the unflipped kernel: ``width + stride - 2`` in all, ``ceil`` of half on
    the left (``width - 1`` where ``stride > width - 1``). Width 4 gives
    ``(2, 1)`` at stride 1 and ``(2, 2)`` at stride 2; Conv-TasNet's
    ``stride = win / 2`` is symmetric."""
    total = width + stride - 2
    left = width - 1 if stride > width - 1 else -(-total // 2)
    return left, total - left


def conv_same(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME")`` over channels-last ``x [B, T, in]``
    with ``kernel [width, in, out]``: ``[B, ceil(T / stride), out]``."""
    left, right = conv_same_pads(x.shape[1], kernel.shape[0], stride)
    y = F.conv1d(F.pad(x.transpose(1, 2), (left, right)), kernel.permute(2, 1, 0), bias,
                 stride=stride)
    return y.transpose(1, 2)


def conv_transpose_same(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int = 1
) -> torch.Tensor:
    """flax ``nn.ConvTranspose(padding="SAME")`` (``transpose_kernel=False``)
    over channels-first ``x [B, in, T]`` with ``kernel [width, in, out]``:
    ``[B, out, T · stride]``. torch's transposed conv pads the dilated input by
    ``width - 1 - padding`` on both sides, plus ``output_padding`` on the
    right, and flips the kernel; the right side's surplus, where lax pads
    less on the right than on the left, is trimmed."""
    width = kernel.shape[0]
    left, right = conv_transpose_pads(width, stride)
    y = F.conv_transpose1d(x, kernel.flip(0).permute(1, 2, 0), bias, stride=stride,
                           padding=width - 1 - left, output_padding=max(right - left, 0))
    return y[..., : x.shape[-1] * stride]


def encode(mix: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, win: int) -> torch.Tensor:
    """flax's strided "SAME" encoder conv and ReLU: ``[B, samples]`` (a
    multiple of ``win // 2``) → ``[B, K, enc_dim]`` in ``kernel``'s dtype;
    ``kernel [win, 1, enc_dim]``. "SAME" pads ``(win - stride) / 2`` each side."""
    stride = win // 2
    y = F.conv1d(mix[:, None, :].to(kernel.dtype), kernel.permute(2, 1, 0), bias, stride=stride,
                 padding=(win - stride) // 2)
    return torch.relu(y).transpose(1, 2)


def decode(masked: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, win: int) -> torch.Tensor:
    """flax's "SAME" ``ConvTranspose`` (``transpose_kernel=False``):
    ``[N, K, enc_dim]`` → ``[N, K · stride]``; ``kernel [win, enc_dim, 1]``.
    torch flips the kernel, so it gets the flipped one."""
    return conv_transpose_same(masked.transpose(1, 2), kernel, bias, win // 2)[:, 0]


def depthwise(y: torch.Tensor, kernel: torch.Tensor, dilation: int, causal: bool = False) -> torch.Tensor:
    """Dilated depthwise conv (no bias) over channels-last ``y [B, T, C]``
    with ``kernel [taps, 1, C]``: "SAME" zero-padding, or ``(taps - 1) ·
    dilation`` frames on the left when causal. Sums in fp32, one rounding to
    ``y.dtype``, as a conv does."""
    taps, frames = kernel.shape[0], y.shape[1]
    total = (taps - 1) * dilation
    left = total if causal else total // 2
    yp = F.pad(y.float(), (0, 0, left, total - left))
    w = kernel[:, 0, :].float()
    out = yp[:, 0:frames] * w[0]
    for t in range(1, taps):
        out = out + yp[:, t * dilation : t * dilation + frames] * w[t]
    return out.to(y.dtype)


class _Conv(nn.Module):
    """flax ``nn.Conv`` parameters: ``kernel [width, in/groups, out]``, ``bias
    [out]`` (``None`` with ``bias=False``)."""

    def __init__(self, width: int, in_per_group: int, out: int, generator=None, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(width, in_per_group, out))
        self.bias = nn.Parameter(torch.zeros(out)) if bias else None
        _lecun_normal_(self.kernel, width * in_per_group, generator)

    def pointwise(self, x: torch.Tensor) -> torch.Tensor:
        """1×1 conv over channels-last ``x``: ``x @ kernel[0] + bias``."""
        flat = x.reshape(-1, x.shape[-1])
        if self.bias is None:
            return (flat @ self.kernel[0]).view(*x.shape[:-1], -1)
        return torch.addmm(self.bias, flat, self.kernel[0]).view(*x.shape[:-1], -1)


class _Norm(nn.Module):
    """gLN (``causal=False``: one mean and variance per item over time and
    channels) or cLN (``causal=True``: per frame over channels and the frames
    up to it), with a learned per-channel affine; statistics in fp32."""

    def __init__(self, channels: int, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, C]
        x32 = x.float()
        if self.causal:
            csum = torch.cumsum(x32.sum(2), dim=1)  # [B, T]
            csum_sq = torch.cumsum(x32.square().sum(2), dim=1)
            count = x.shape[2] * torch.arange(1, x.shape[1] + 1, dtype=torch.float32, device=x.device)
            mean = (csum / count)[..., None]
            var = torch.clamp(csum_sq / count - (csum / count).square(), min=0.0)[..., None]
        else:
            mean = x32.mean(dim=(1, 2), keepdim=True)
            mean_sq = x32.square().mean(dim=(1, 2), keepdim=True)
            var = torch.clamp(mean_sq - mean.square(), min=0.0)
        out = self.gamma.float() * (x32 - mean) / torch.sqrt(var + _EPS) + self.beta.float()
        return out.to(x.dtype)


class _PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class _TCNBlock(nn.Module):
    def __init__(
        self, hidden: int, bottleneck: int, kernel: int, dilation: int, causal: bool, generator
    ):
        super().__init__()
        self.dilation, self.causal = dilation, causal
        self.expand = _Conv(1, bottleneck, hidden, generator)
        self.prelu1 = _PReLU()
        self.norm1 = _Norm(hidden, causal)
        self.depthwise = _Conv(kernel, 1, hidden, generator)
        self.prelu2 = _PReLU()
        self.norm2 = _Norm(hidden, causal)
        self.res_out = _Conv(1, hidden, bottleneck, generator)
        self.skip_out = _Conv(1, hidden, bottleneck, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        y = self.norm1(self.prelu1(self.expand.pointwise(x)))
        y = depthwise(y, self.depthwise.kernel, self.dilation, self.causal) + self.depthwise.bias
        y = self.norm2(self.prelu2(y))
        return x + self.res_out.pointwise(y), self.skip_out.pointwise(y)


class ConvTasNet(nn.Module):
    def __init__(
        self,
        num_speakers: int = 2,
        enc_dim: int = 256,
        win: int = 16,
        bottleneck: int = 128,
        hidden: int = 256,
        kernel: int = 3,
        blocks: int = 7,
        repeats: int = 3,
        causal: bool = False,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_speakers, self.enc_dim, self.win = num_speakers, enc_dim, win
        self.bottleneck, self.hidden, self.kernel = bottleneck, hidden, kernel
        self.blocks, self.repeats, self.causal = blocks, repeats, causal
        self.encoder = _Conv(win, 1, enc_dim, generator)
        self.input_norm = _Norm(enc_dim, causal)
        self.input_proj = _Conv(1, enc_dim, bottleneck, generator)
        for r in range(repeats):
            for x in range(blocks):
                self.add_module(
                    f"tcn_{r}_{x}",
                    _TCNBlock(hidden, bottleneck, kernel, 2**x, causal, generator),
                )
        self.mask_prelu = _PReLU()
        self.mask_proj = _Conv(1, bottleneck, num_speakers * enc_dim, generator)
        # flax ConvTranspose: kernel [win, in_features, features], fan_in = win * in
        self.decoder = _Conv(win, enc_dim, 1, generator)

    @property
    def stride(self) -> int:
        return self.win // 2

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        """``mix``: ``[B, samples]`` (a multiple of ``win // 2``) → fp32 ``[B, S, samples]``."""
        b, samples = mix.shape
        if samples % self.stride:
            raise ValueError(f"pad waveforms to a multiple of win//2 = {self.stride}, got {samples}")
        feats = encode(mix, self.encoder.kernel, self.encoder.bias, self.win)  # [B, K, N]
        h = self.input_proj.pointwise(self.input_norm(feats))
        skip_sum = torch.zeros_like(h)
        for r in range(self.repeats):
            for x in range(self.blocks):
                h, skip = getattr(self, f"tcn_{r}_{x}")(h)
                skip_sum = skip_sum + skip
        masks = torch.sigmoid(self.mask_proj.pointwise(self.mask_prelu(skip_sum)))
        k = feats.shape[1]
        masked = masks.view(b, k, self.num_speakers, self.enc_dim) * feats[:, :, None, :]
        masked = masked.transpose(1, 2).reshape(b * self.num_speakers, k, self.enc_dim)
        wav = decode(masked, self.decoder.kernel, self.decoder.bias, self.win)
        wav = wav.reshape(b, self.num_speakers, -1).float()
        return wav[:, :, :samples]
