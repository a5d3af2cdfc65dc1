"""Plain reference of DPRNN-TasNet (Luo, Chen and Yoshioka, ICASSP 2020,
arXiv:1910.06379), in plain PyTorch.

- encoder: Conv1D(E, kernel L, stride L/2), ReLU;
- gLN over each item, then a 1×1 bottleneck E → N;
- segmentation: chunks of K frames with hop P = K/2; P zeros in front and
  as many behind as put every frame in two chunks, S = ceil(T / P) + 1;
- ``blocks`` dual-path blocks: over the K frames of each chunk (intra), then
  over the S chunks at each chunk position (inter), each a BiLSTM of
  ``hidden`` units a direction (gates i, f, g, o; sigmoid, tanh), a linear
  map 2·hidden → N, gLN over the item's S·K frames and N channels, and the
  residual;
- mask head: PReLU, 1×1 N → speakers·E per chunk frame, overlap-add (a
  frame's two chunks summed), sigmoid, times the encoder's output;
- decoder: one transposed Conv1D (kernel L, stride L/2) a speaker.

Departures from the paper, as the configuration lists them (``assumed``):
the encoder and decoder pad as flax's "SAME" does (L = 2, stride 1: one zero
after the last sample; the transposed conv correlates the input, one zero in
front, with its kernel unflipped); each LSTM gate has one bias (Keras's
layout); gLN sees the padded item, zeros past an utterance's end included;
the mask is a sigmoid (the paper fixes no activation).

It imports nothing of the program and takes no weights from it: the weights
come from :func:`make_weights` and the seed. It computes in fp32 with TF32
off. Every product's operands pass through the precision's rounding
(``precision.py``): ``fp32`` is the reference, ``tf32`` the control, ``fp64``
computes everything in float64 (a witness above the reference). The
recurrences are one loop over time, both directions at once; the items go
through in blocks of :data:`ROWS_A_BLOCK`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.precision import dtype, rounding

_EPS = 1e-8
ROWS_A_BLOCK = 16  # items the reference runs at once, to bound its memory


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, by the name the port's ``state_dict`` uses."""
    e, win, n, h = cfg["enc_dim"], cfg["win"], cfg["bottleneck"], cfg["hidden"]
    shapes = {
        "encoder.kernel": (win, 1, e), "encoder.bias": (e,),
        "input_norm.gamma": (e,), "input_norm.beta": (e,),
        "input_proj.kernel": (1, e, n), "input_proj.bias": (n,),
    }
    for i in range(cfg["blocks"]):
        for part in ("intra", "inter"):
            pre = f"dp_{i}.{part}_"
            shapes.update({
                pre + "rnn.cells.kernel": (2, n, 4 * h),
                pre + "rnn.cells.recurrent_kernel": (2, h, 4 * h),
                pre + "rnn.cells.bias": (2, 4 * h),
                pre + "proj.kernel": (1, 2 * h, n), pre + "proj.bias": (n,),
                pre + "norm.gamma": (n,), pre + "norm.beta": (n,),
            })
    shapes.update({
        "mask_prelu.alpha": (1,),
        "mask_proj.kernel": (1, n, cfg["num_speakers"] * e),
        "mask_proj.bias": (cfg["num_speakers"] * e,),
        "decoder.kernel": (win, e, 1), "decoder.bias": (1,),
    })
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random fp32 weights from the seed, made on ``device`` in one draw:
    kernels normal with variance 1/fan-in (an LSTM's over its input or its
    hidden units, a conv's over its taps and input channels); biases and
    norm shifts normal with std 0.1, plus 1 on each LSTM's forget-gate slice
    (Keras's ``unit_forget_bias``); norm scales 1 + 0.2·normal; the PReLU
    slope 0.25 + 0.05·normal."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = torch.randn(total, generator=gen, device=device)
    weights, at = {}, 0
    hidden = cfg["hidden"]
    for name, shape in shapes.items():
        size = math.prod(shape)
        w = flat[at:at + size].view(shape).clone()
        at += size
        leaf = name.rsplit(".", 1)[-1]
        if ".cells." in name and leaf != "bias":
            w *= 1.0 / math.sqrt(shape[-2])
        elif leaf == "kernel":
            w *= 1.0 / math.sqrt(shape[0] * shape[1])
        elif leaf == "gamma":
            w = 1.0 + 0.2 * w
        elif leaf == "alpha":
            w = 0.25 + 0.05 * w
        else:  # bias, beta
            w *= 0.1
            if ".cells." in name:
                w[..., hidden:2 * hidden] += 1.0
        weights[name] = w
    return weights


def frames(cfg: dict, samples):
    """Encoder frames of ``samples`` (a multiple of the stride L/2)."""
    return np.asarray(samples) // (cfg["win"] // 2)


def flops_per_frame(cfg: dict) -> int:
    """Multiply-adds (two operations each) of the products an encoder frame,
    counted from the widths: the encoder and the bottleneck; in each block,
    both halves' BiLSTM input and recurrent products in both directions and
    their linear maps, on each of the frame's K/P = 2 chunk frames; the mask
    projection on those two; the decoder for each speaker."""
    e, win, n, h, s = cfg["enc_dim"], cfg["win"], cfg["bottleneck"], cfg["hidden"], cfg["num_speakers"]
    overlap = 2  # chunks overlap by half
    half = 2 * (2 * n * 4 * h + 2 * h * 4 * h) + 2 * (2 * h) * n
    return (2 * win * e + 2 * e * n + overlap * (cfg["blocks"] * 2 * half + 2 * n * s * e)
            + s * 2 * e * win)


class _RoundedMatmul(torch.autograd.Function):
    """``q(a) @ q(b)``, with the backward's products rounded alike; ``b`` is
    ``[k, n]``, or ``[D, k, n]`` under ``a [D, m, k]``."""

    @staticmethod
    def forward(ctx, a, b, q):
        qa, qb = q(a), q(b)
        ctx.save_for_backward(qa, qb)
        ctx.q = q
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.q(g)
        ga = qg @ qb.transpose(-1, -2)
        if qb.dim() == 2:
            gb = qa.reshape(-1, qa.shape[-1]).T @ qg.reshape(-1, qg.shape[-1])
        else:
            gb = qa.transpose(-1, -2) @ qg
        return ga, gb, None


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision in ("fp32", "fp64"):
        return a @ b
    return _RoundedMatmul.apply(a, b, rounding(precision))


def _gln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Over ``[B, L, C]``: one mean and variance an item, a per-channel affine."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + _EPS) + beta


def _bilstm(x: torch.Tensor, kernel, recurrent, bias, precision: str) -> torch.Tensor:
    """``[R, L, F]`` → ``[R, L, 2H]``: direction 0 forwards, 1 backwards."""
    rows, steps, _ = x.shape
    hidden = recurrent.shape[1]
    xw = torch.stack([_mm(x, kernel[d], precision) + bias[d] for d in range(2)])  # [2, R, L, 4H]
    h = x.new_zeros((2, rows, hidden))
    c = x.new_zeros((2, rows, hidden))
    outs = [[None] * steps for _ in range(2)]
    for s in range(steps):
        z = torch.stack([xw[0, :, s], xw[1, :, steps - 1 - s]]) + _mm(h, recurrent, precision)
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[0][s] = h[0]
        outs[1][steps - 1 - s] = h[1]
    return torch.cat([torch.stack(outs[0], dim=1), torch.stack(outs[1], dim=1)], dim=-1)


def _chunk_index(count: int, hop: int, device) -> torch.Tensor:
    """``[S, K]``: the padded frame each chunk position reads."""
    starts = torch.arange(count, device=device)[:, None] * hop
    return starts + torch.arange(2 * hop, device=device)[None, :]


def forward(w: dict, cfg: dict, mix: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` → ``[B, speakers, samples]``, differentiable;
    ``w`` in the precision's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = rounding(precision)
    win, stride, hop = cfg["win"], cfg["win"] // 2, cfg["chunk"] // 2
    n_spk, e, n = cfg["num_speakers"], cfg["enc_dim"], cfg["bottleneck"]
    bsz, samples = mix.shape

    def pointwise(x, name):
        return _mm(x, w[name + ".kernel"][0], precision) + w[name + ".bias"]

    left = (win - stride) // 2
    padded = F.pad(q(mix)[:, None, :], (left, win - stride - left))
    feats = torch.relu(F.conv1d(padded, q(w["encoder.kernel"]).permute(2, 1, 0),
                                w["encoder.bias"], stride=stride)).transpose(1, 2)  # [B, T, E]
    t = feats.shape[1]
    h = pointwise(_gln(feats, w["input_norm.gamma"], w["input_norm.beta"]), "input_proj")
    count = -(-t // hop) + 1
    index = _chunk_index(count, hop, mix.device)
    k = 2 * hop
    h = F.pad(h, (0, 0, hop, (count + 1) * hop - hop - t))[:, index]  # [B, S, K, N]
    for i in range(cfg["blocks"]):
        for part in ("intra", "inter"):
            pre = f"dp_{i}.{part}_"
            rows = h if part == "intra" else h.transpose(1, 2)  # [B, chunks or positions, L, N]
            lead, length = rows.shape[1], rows.shape[2]
            y = _bilstm(rows.reshape(bsz * lead, length, n), w[pre + "rnn.cells.kernel"],
                        w[pre + "rnn.cells.recurrent_kernel"], w[pre + "rnn.cells.bias"], precision)
            y = _gln(pointwise(y, pre + "proj").reshape(bsz, lead * length, n),
                     w[pre + "norm.gamma"], w[pre + "norm.beta"]).reshape(bsz, lead, length, n)
            h = h + (y if part == "intra" else y.transpose(1, 2))
    act = torch.where(h >= 0, h, w["mask_prelu.alpha"] * h)
    per_chunk = pointwise(act, "mask_proj").reshape(bsz, count * k, n_spk * e)
    summed = per_chunk.new_zeros(bsz, (count + 1) * hop, n_spk * e)
    summed = summed.index_add(1, index.reshape(-1), per_chunk)
    masks = torch.sigmoid(summed[:, hop:hop + t])
    masked = masks.view(bsz, t, n_spk, e) * feats[:, :, None, :]
    masked = masked.permute(0, 2, 3, 1).reshape(bsz * n_spk, e, t)
    # flax's "SAME" transposed conv: the stride-dilated input padded on the
    # left by ceil((L + stride - 2) / 2) (L - 1 where stride > L - 1) and
    # correlated with the unflipped kernel, as torch's transposed conv
    # computes it with the kernel flipped and padding L - 1 - left
    front = win - 1 if stride > win - 1 else -(-(win + stride - 2) // 2)
    wav = F.conv_transpose1d(q(masked), q(w["decoder.kernel"]).flip(0).permute(1, 2, 0),
                             w["decoder.bias"], stride=stride, padding=win - 1 - front)
    return wav[:, 0, :samples].reshape(bsz, n_spk, samples)


@torch.no_grad()
def separate(weights: dict, cfg: dict, mix: torch.Tensor, frame_lengths=None,
             precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` (a multiple of L/2) → ``[B, S, samples]``, in
    blocks of items. ``frame_lengths`` is unused: gLN sees the padded item,
    as the served model does."""
    dt = dtype(precision)
    w = {k: v.to(dt) for k, v in weights.items()}
    return torch.cat([forward(w, cfg, mix[i:i + ROWS_A_BLOCK].to(dt), precision)
                      for i in range(0, mix.shape[0], ROWS_A_BLOCK)])
