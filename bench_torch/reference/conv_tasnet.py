"""Plain reference of Conv-TasNet (Luo & Mesgarani, arXiv:1809.07454), gLN
(non-causal) topology, in plain PyTorch.

- encoder: Conv1D(N, kernel L, stride L/2, "SAME" padding), ReLU;
- separator: gLN, 1×1 bottleneck to B, R repeats of X dilated blocks
  (dilation 2^x): 1×1 to H, PReLU, gLN, depthwise conv of P taps ("SAME"),
  PReLU, gLN, then a 1×1 residual output of B channels and a 1×1 skip
  output of Sc channels; the skips summed;
- masks: PReLU, 1×1 from Sc to S·N, sigmoid, times the encoder's output;
- decoder: one transposed Conv1D (kernel L, stride L/2, "SAME") back to the
  waveform, a speaker at a time.

gLN normalises each item over time and channels, with a per-channel affine;
its statistics are fp32 in every precision. Layouts are flax's (Conv kernels
``[width, in/groups, out]``), which the port's ``state_dict`` keeps, and the
transposed conv is flax's (``transpose_kernel=False``): it correlates the
stride-dilated input with the kernel unflipped.

It imports nothing of the program and takes no weights from it. Every
product's operands and every activation stored between layers pass through
the precision's rounding (``precision.py``): ``fp32`` is the reference,
``bf16`` the program's own storage precision and ``fp64`` float64 (two
witnesses), ``fp8`` the control: the model stored in fp8, the step that
would tempt a later change.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.precision import dtype, rounding

_EPS = 1e-8
ROWS_A_BLOCK = 16  # rows the reference runs at once, to bound its memory


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, by the name the port's ``state_dict`` uses."""
    n, win, b, h, p = cfg["enc_dim"], cfg["win"], cfg["bottleneck"], cfg["hidden"], cfg["kernel"]
    sc = cfg["skip_channels"]
    shapes = {
        "encoder.kernel": (win, 1, n), "encoder.bias": (n,),
        "input_norm.gamma": (n,), "input_norm.beta": (n,),
        "input_proj.kernel": (1, n, b), "input_proj.bias": (b,),
    }
    for r in range(cfg["repeats"]):
        for x in range(cfg["blocks"]):
            pre = f"tcn_{r}_{x}."
            shapes.update({
                pre + "expand.kernel": (1, b, h), pre + "expand.bias": (h,),
                pre + "prelu1.alpha": (1,),
                pre + "norm1.gamma": (h,), pre + "norm1.beta": (h,),
                pre + "depthwise.kernel": (p, 1, h), pre + "depthwise.bias": (h,),
                pre + "prelu2.alpha": (1,),
                pre + "norm2.gamma": (h,), pre + "norm2.beta": (h,),
                pre + "res_out.kernel": (1, h, b), pre + "res_out.bias": (b,),
                pre + "skip_out.kernel": (1, h, sc), pre + "skip_out.bias": (sc,),
            })
    shapes.update({
        "mask_prelu.alpha": (1,),
        "mask_proj.kernel": (1, sc, cfg["num_speakers"] * n), "mask_proj.bias": (cfg["num_speakers"] * n,),
        "decoder.kernel": (win, n, 1), "decoder.bias": (1,),
    })
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random fp32 weights from the seed, made on ``device`` in one draw:
    kernels normal with variance 1/fan-in; biases and norm shifts normal with
    std 0.1; norm scales 1 + 0.2·normal; PReLU slopes 0.25 + 0.05·normal (the
    norms and slopes moved off their initial values, so that the folds of
    the serving path have something to fold)."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = torch.randn(total, generator=gen, device=device)
    weights, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape).clone()
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            w *= 1.0 / math.sqrt(shape[0] * shape[1])
        elif leaf == "gamma":
            w = 1.0 + 0.2 * w
        elif leaf == "alpha":
            w = 0.25 + 0.05 * w
        else:  # bias, beta
            w *= 0.1
        weights[name] = w
    return weights


def frames(cfg: dict, samples):
    """Encoder frames of ``samples`` (a multiple of the stride L/2)."""
    return np.asarray(samples) // (cfg["win"] // 2)


def flops_per_frame(cfg: dict) -> int:
    """Multiply-adds (two operations each) of the products an encoder frame,
    counted from the widths: encoder, bottleneck, each block's 1×1 expand,
    depthwise taps and residual and skip outputs, the mask projection, and
    the decoder for each speaker."""
    n, win, b, h, p = cfg["enc_dim"], cfg["win"], cfg["bottleneck"], cfg["hidden"], cfg["kernel"]
    s, sc = cfg["num_speakers"], cfg["skip_channels"]
    block = 2 * b * h + 2 * p * h + 2 * h * (b + sc)
    return (2 * win * n + 2 * n * b + cfg["repeats"] * cfg["blocks"] * block
            + 2 * sc * s * n + s * 2 * n * win)


def _gln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + _EPS) + beta


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _forward(w: dict, cfg: dict, mix: torch.Tensor, q) -> torch.Tensor:
    """``mix [B, samples]`` → ``[B, S, samples]``: every product's operands
    and every activation stored between layers (the encoder's output, the
    residual stream, the skip sum, each block's intermediates, the masks, the
    estimates returned) rounded by ``q``, as the served model stores them in
    its precision; accumulation and norm statistics fp32 (fp64 at ``fp64``)."""
    win, stride = cfg["win"], cfg["win"] // 2
    n_spk, n = cfg["num_speakers"], cfg["enc_dim"]
    bsz, samples = mix.shape

    def pointwise(x, name):
        return q(x) @ q(w[name + ".kernel"][0]) + w[name + ".bias"]

    feats = q(torch.relu(F.conv1d(q(mix)[:, None, :], q(w["encoder.kernel"]).permute(2, 1, 0),
                                  w["encoder.bias"], stride=stride,
                                  padding=(win - stride) // 2)).transpose(1, 2))  # [B, K, N]
    h = q(pointwise(_gln(feats, w["input_norm.gamma"], w["input_norm.beta"]), "input_proj"))
    skip = h.new_zeros(*h.shape[:2], cfg["skip_channels"])
    frames_k = h.shape[1]
    for r in range(cfg["repeats"]):
        for x in range(cfg["blocks"]):
            pre = f"tcn_{r}_{x}."
            y = q(_prelu(pointwise(h, pre + "expand"), w[pre + "prelu1.alpha"]))
            y = q(_gln(y, w[pre + "norm1.gamma"], w[pre + "norm1.beta"]))
            dil, taps = 2 ** x, cfg["kernel"]
            total = (taps - 1) * dil
            yp = F.pad(y, (0, 0, total // 2, total - total // 2))
            kern = q(w[pre + "depthwise.kernel"])[:, 0, :]
            y = sum(yp[:, t * dil:t * dil + frames_k] * kern[t] for t in range(taps))
            y = q(_prelu(y + w[pre + "depthwise.bias"], w[pre + "prelu2.alpha"]))
            y = _gln(y, w[pre + "norm2.gamma"], w[pre + "norm2.beta"])
            h = q(h + pointwise(y, pre + "res_out"))
            skip = q(skip + pointwise(y, pre + "skip_out"))
    masks = q(torch.sigmoid(pointwise(_prelu(skip, w["mask_prelu.alpha"]), "mask_proj")))
    masked = masks.view(bsz, frames_k, n_spk, n) * feats[:, :, None, :]
    masked = masked.permute(0, 2, 3, 1).reshape(bsz * n_spk, n, frames_k)
    # flax's "SAME" transposed conv: the stride-dilated input padded by
    # (29, 29) for L = 40, correlated with the unflipped kernel, which torch's
    # transposed conv computes with the kernel flipped and padding L - 1 - 29
    left = -(-(win + stride - 2) // 2) if stride <= win - 1 else win - 1
    wav = F.conv_transpose1d(q(masked), q(w["decoder.kernel"]).flip(0).permute(1, 2, 0),
                             w["decoder.bias"], stride=stride, padding=win - 1 - left)
    return q(wav[:, 0, :samples].reshape(bsz, n_spk, samples))


@torch.no_grad()
def separate(weights: dict, cfg: dict, mix: torch.Tensor, frame_lengths=None,
             precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` (a multiple of L/2) → ``[B, S, samples]``, in
    blocks of rows. ``frame_lengths`` is unused: gLN sees the padded item, as
    the served model does."""
    q, dt = rounding(precision), dtype(precision)
    w = {k: v.to(dt) for k, v in weights.items()}
    return torch.cat([_forward(w, cfg, mix[i:i + ROWS_A_BLOCK].to(dt), q)
                      for i in range(0, mix.shape[0], ROWS_A_BLOCK)])
