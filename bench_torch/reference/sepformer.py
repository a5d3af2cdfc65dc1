"""Plain reference of SepFormer (Subakan, Ravanelli, Cornell, Bronzi and
Zhong, ICASSP 2021, arXiv:2010.13154; the equations of SpeechBrain's
WSJ0-2mix recipe, ``lobes/models/dual_path.py`` with ``Dual_Path_Model``,
``Dual_Computation_Block`` and ``SBTransformerBlock``), in plain PyTorch.

- encoder: Conv1D(E, kernel L, stride L/2, no bias), ReLU;
- gLN over each item (GroupNorm with one group, eps 1e-8), then a 1×1
  E → d with no bias;
- segmentation: chunks of K frames with hop P = K/2; P zeros in front and
  as many behind as put every frame in two chunks, S = ceil(T / P) + 1;
- ``blocks`` dual-path blocks: over the K frames of each chunk (intra), then
  over the S chunks at each chunk position (inter); each half adds the
  sinusoidal positions 0 .. L−1 (sin at even channels, cos at odd, rate
  10000^(−2i/d)), runs ``layers`` pre-LN transformer layers (x + MHA(LN(x)),
  x + FFN(LN(x)); ``heads`` heads with biased in- and out-projections;
  Linear d → ``ffn``, ReLU, Linear back; LN eps 1e-6) and a final LN, then
  gLN over the item's S·K frames and d channels, and the residual;
- mask head: PReLU, 1×1 d → speakers·d per chunk frame (biased),
  overlap-add (a frame's two chunks summed), then per speaker
  tanh(1×1) · sigmoid(1×1) (both biased), 1×1 d → E with no bias and ReLU:
  the mask, times the encoder's output;
- decoder: one transposed Conv1D (kernel L, stride L/2, no bias) a speaker.

Departures from SpeechBrain, as the configuration lists them (``assumed``):
the encoder and decoder pad as flax's "SAME" does (L = 16, stride 8: four
zeros a side; the transposed conv correlates the input, padded in front,
with its kernel unflipped), and the segmentation is the port's DPRNN's, not
SpeechBrain's padding to whole chunks. No attention mask: padded frames
attend like any other.

It imports nothing of the program and takes no weights from it: the weights
come from :func:`make_weights` and the seed. It computes in fp32 with TF32
off. Every product's operands pass through the precision's rounding
(``precision.py``): ``fp32`` is the reference, ``fp8`` the control of a bf16
configuration, ``fp64`` computes everything in float64. The attention is
written out (the scores, their softmax, the product with V); the items go
through in blocks of :data:`ROWS_A_BLOCK`. The rounded product, gLN and the
chunk index are the DPRNN reference's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.precision import dtype, rounding
from bench_torch.reference.dprnn import _chunk_index, _gln, _mm

_LN_EPS = 1e-6
ROWS_A_BLOCK = 8  # items the reference runs at once, to bound its memory (scores are [R, h, L, L])


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, by the name the port's ``state_dict`` uses."""
    e, win, d, f, s = cfg["enc_dim"], cfg["win"], cfg["d_model"], cfg["ffn"], cfg["num_speakers"]
    shapes = {
        "encoder.kernel": (win, 1, e),
        "input_norm.gamma": (e,), "input_norm.beta": (e,),
        "input_proj.kernel": (1, e, d),
    }
    for i in range(cfg["blocks"]):
        for part in ("intra", "inter"):
            for j in range(cfg["layers"]):
                pre = f"dp_{i}.{part}.layer_{j}."
                shapes.update({
                    pre + "attn_norm.gamma": (d,), pre + "attn_norm.beta": (d,),
                    pre + "attn_in.kernel": (1, d, 3 * d), pre + "attn_in.bias": (3 * d,),
                    pre + "attn_out.kernel": (1, d, d), pre + "attn_out.bias": (d,),
                    pre + "ffn_norm.gamma": (d,), pre + "ffn_norm.beta": (d,),
                    pre + "ffn_in.kernel": (1, d, f), pre + "ffn_in.bias": (f,),
                    pre + "ffn_out.kernel": (1, f, d), pre + "ffn_out.bias": (d,),
                })
            shapes.update({f"dp_{i}.{part}.norm.gamma": (d,), f"dp_{i}.{part}.norm.beta": (d,),
                           f"dp_{i}.{part}_norm.gamma": (d,), f"dp_{i}.{part}_norm.beta": (d,)})
    shapes.update({
        "mask_prelu.alpha": (1,),
        "mask_proj.kernel": (1, d, s * d), "mask_proj.bias": (s * d,),
        "gate_tanh.kernel": (1, d, d), "gate_tanh.bias": (d,),
        "gate_sigmoid.kernel": (1, d, d), "gate_sigmoid.bias": (d,),
        "mask_out.kernel": (1, d, e),
        "decoder.kernel": (win, e, 1),
    })
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random fp32 weights from the seed, made on ``device`` in one draw, as
    the DPRNN reference makes its own: kernels normal with variance
    1/fan-in (over taps and input channels); biases and norm shifts normal
    with std 0.1; norm scales 1 + 0.2·normal; the PReLU slope 0.25 +
    0.05·normal."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = torch.randn(total, generator=gen, device=device)
    weights, at = {}, 0
    for name, shape in shapes.items():
        size = math.prod(shape)
        w = flat[at:at + size].view(shape).clone()
        at += size
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
    counted from the widths: the encoder and the bottleneck; in each block,
    on each of the frame's K/P = 2 chunk frames, both halves' layers (the
    in-projection d → 3d, the out-projection, the FFN's two Linears) and
    the intra attention's QKᵀ and PV over the K frames of its chunk
    (4·K·d); the mask projection on those two; the gates and the mask's 1×1
    for each speaker; the decoder for each speaker.

    The inter attention's QKᵀ and PV (4·S·d a chunk frame, S growing with
    the batch's length) are left out: at 10 s, S = 81 and they are 2.4% of
    the total, so the count, and the MFU read from it, never overstates."""
    e, win, d, f, s = cfg["enc_dim"], cfg["win"], cfg["d_model"], cfg["ffn"], cfg["num_speakers"]
    overlap = 2  # chunks overlap by half
    layer = 2 * d * 3 * d + 2 * d * d + 2 * 2 * d * f
    block = cfg["layers"] * (2 * layer + 4 * cfg["chunk"] * d)
    return (2 * win * e + 2 * e * d + overlap * (cfg["blocks"] * block + 2 * d * s * d)
            + s * (2 * 2 * d * d + 2 * d * e) + s * 2 * e * win)


def _layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return gamma * (x - mean) / torch.sqrt(var + _LN_EPS) + beta


def _positions(length: int, channels: int, like: torch.Tensor) -> torch.Tensor:
    """``[length, channels]``: sin(p / 10000^(2i/d)) at channel 2i, cos at 2i + 1."""
    p = torch.arange(length, dtype=torch.float64)[:, None]
    angle = p / torch.pow(10000.0, torch.arange(0, channels, 2, dtype=torch.float64) / channels)
    table = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(length, channels)
    return table.to(device=like.device, dtype=like.dtype)


def _transformer(x: torch.Tensor, w: dict, pre: str, cfg: dict, precision: str) -> torch.Tensor:
    """One half's stack over rows ``x [R, L, d]``."""
    rows, length, d = x.shape
    heads = cfg["heads"]
    hd = d // heads

    def linear(y, name):
        return _mm(y, w[name + ".kernel"][0], precision) + w[name + ".bias"]

    x = x + _positions(length, d, x)
    for j in range(cfg["layers"]):
        lp = f"{pre}.layer_{j}."
        y = _layer_norm(x, w[lp + "attn_norm.gamma"], w[lp + "attn_norm.beta"])
        qkv = linear(y, lp + "attn_in").reshape(rows, length, 3, heads, hd).permute(2, 0, 3, 1, 4)
        scores = _mm(qkv[0], qkv[1].transpose(-1, -2), precision) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        y = _mm(probs, qkv[2], precision).transpose(1, 2).reshape(rows, length, d)
        x = x + linear(y, lp + "attn_out")
        y = _layer_norm(x, w[lp + "ffn_norm.gamma"], w[lp + "ffn_norm.beta"])
        x = x + linear(torch.relu(linear(y, lp + "ffn_in")), lp + "ffn_out")
    return _layer_norm(x, w[pre + ".norm.gamma"], w[pre + ".norm.beta"])


def forward(w: dict, cfg: dict, mix: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` → ``[B, speakers, samples]``, differentiable;
    ``w`` in the precision's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q = rounding(precision)
    win, stride, hop = cfg["win"], cfg["win"] // 2, cfg["chunk"] // 2
    n_spk, e, d = cfg["num_speakers"], cfg["enc_dim"], cfg["d_model"]
    bsz, samples = mix.shape

    def pointwise(x, name):
        y = _mm(x, w[name + ".kernel"][0], precision)
        return y + w[name + ".bias"] if name + ".bias" in w else y

    left = (win - stride) // 2
    padded = F.pad(q(mix)[:, None, :], (left, win - stride - left))
    feats = torch.relu(F.conv1d(padded, q(w["encoder.kernel"]).permute(2, 1, 0),
                                stride=stride)).transpose(1, 2)  # [B, T, E]
    t = feats.shape[1]
    h = pointwise(_gln(feats, w["input_norm.gamma"], w["input_norm.beta"]), "input_proj")
    count = -(-t // hop) + 1
    index = _chunk_index(count, hop, mix.device)
    k = 2 * hop
    h = F.pad(h, (0, 0, hop, (count + 1) * hop - hop - t))[:, index]  # [B, S, K, d]
    for i in range(cfg["blocks"]):
        for part in ("intra", "inter"):
            pre = f"dp_{i}.{part}"
            rows = h if part == "intra" else h.transpose(1, 2)  # [B, chunks or positions, L, d]
            lead, length = rows.shape[1], rows.shape[2]
            y = _transformer(rows.reshape(bsz * lead, length, d), w, pre, cfg, precision)
            y = _gln(y.reshape(bsz, lead * length, d),
                     w[pre + "_norm.gamma"], w[pre + "_norm.beta"]).reshape(bsz, lead, length, d)
            h = h + (y if part == "intra" else y.transpose(1, 2))
    act = torch.where(h >= 0, h, w["mask_prelu.alpha"] * h)
    per_chunk = pointwise(act, "mask_proj").reshape(bsz, count * k, n_spk * d)
    summed = per_chunk.new_zeros(bsz, (count + 1) * hop, n_spk * d)
    summed = summed.index_add(1, index.reshape(-1), per_chunk)
    y = summed[:, hop:hop + t].reshape(bsz, t, n_spk, d)
    gated = torch.tanh(pointwise(y, "gate_tanh")) * torch.sigmoid(pointwise(y, "gate_sigmoid"))
    masks = torch.relu(pointwise(gated, "mask_out"))  # [B, T, speakers, E]
    masked = (masks * feats[:, :, None, :]).permute(0, 2, 3, 1).reshape(bsz * n_spk, e, t)
    # flax's "SAME" transposed conv: the stride-dilated input padded on the
    # left by ceil((L + stride - 2) / 2) (L - 1 where stride > L - 1) and
    # correlated with the unflipped kernel, as torch's transposed conv
    # computes it with the kernel flipped and padding L - 1 - left
    front = win - 1 if stride > win - 1 else -(-(win + stride - 2) // 2)
    wav = F.conv_transpose1d(q(masked), q(w["decoder.kernel"]).flip(0).permute(1, 2, 0),
                             stride=stride, padding=win - 1 - front)
    return wav[:, 0, :samples].reshape(bsz, n_spk, samples)


@torch.no_grad()
def separate(weights: dict, cfg: dict, mix: torch.Tensor, frame_lengths=None,
             precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` (a multiple of L/2) → ``[B, S, samples]``, in
    blocks of items. ``frame_lengths`` is unused: gLN sees the padded item
    and every frame attends to every other, as in the served model."""
    dt = dtype(precision)
    w = {k: v.to(dt) for k, v in weights.items()}
    return torch.cat([forward(w, cfg, mix[i:i + ROWS_A_BLOCK].to(dt), precision)
                      for i in range(0, mix.shape[0], ROWS_A_BLOCK)])
