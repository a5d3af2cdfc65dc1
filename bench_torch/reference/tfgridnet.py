"""Plain reference of TF-GridNet (Wang, Cornell, Choi, Lee, Kim and Watanabe,
IEEE/ACM TASLP 2023, arXiv:2211.12433; the equations of ESPnet's
``espnet2/enh/separator/tfgridnet_separator.py``: ``TFGridNet``,
``GridNetBlock``, ``LayerNormalization4D``, ``LayerNormalization4DCF``), in
plain PyTorch, channels first as ESPnet writes it.

- the mixture divided by its standard deviation (unbiased, over the item);
- STFT: ``n_fft``-sample frames every ``hop`` samples of the mixture with
  ``n_fft − hop`` zeros a side (and zeros to a whole frame), the square root
  of the periodic Hann window, a DFT as a product with a cos / −sin basis →
  (real, imag) ``[B, 2, T, F]``;
- Conv2d(2 → D, 3×3, padding 1, biased), GroupNorm(1, D) (eps ``eps``);
- ``blocks`` GridNet blocks on ``[B, D, T, F]``:

  1. intra: LN over D at each (t, f) (``LayerNormalization4D``); each frame's
     F bins in windows of I at stride 1, the window's I·D values ordered tap
     by tap (feature k·D + c is bin p + k, channel c); a BiLSTM of ``hidden``
     units a direction (gates i, f, g, o; one bias a gate); ConvTranspose1d
     (2·hidden → D, kernel I, biased) back to F bins; plus the block's input;
  2. inter: the same over the T frames at each bin;
  3. attention: for each head l, Q_l and K_l = LN₍E,F₎(PReLU_l(Conv1×1(D →
     E))) and V_l = LN₍D/L,F₎(PReLU_l(Conv1×1(D → D/L))), each frame's
     (channel, bin) plane flattened channel by channel, softmax(Q Kᵀ /
     √(E·F)) V written out (scores, softmax, product); the heads stacked
     along the channels (head-major), LN₍D,F₎(PReLU(Conv1×1(D → D))), plus
     the attention's input. LN₍C,F₎ normalises over a frame's C channels and
     F bins with a scale and shift a (channel, bin) (``LayerNormalization4DCF``);
- ConvTranspose2d(D → 2·speakers, 3×3, padding 1, biased): speaker s's real
  part at channel 2s, its imaginary part at 2s + 1;
- iSTFT: an inverse DFT a frame (DC and Nyquist once, the other bins twice,
  over ``n_fft``), times the synthesis window w / Σ_j w(n mod hop + j·hop)²,
  overlap-added; the fade pads cut; times the standard deviation.

Departures from ESPnet, as the configuration lists them (``assumed``): zero
fade pads of ``n_fft − hop`` a side where ``torch.stft`` centres with
reflected pads; one LSTM bias a gate; the deviation and GroupNorm over the
padded item; no attention mask. The unfolded window's feature order (tap by
tap, where ``F.unfold`` orders channel by channel) is a relabelling of the
BiLSTM's input kernel.

It imports nothing of the program and takes no weights from it: the weights
come from :func:`make_weights` and the seed. It computes in fp32 with TF32
off. The operands of every product that the served configuration runs in
bf16 (the BiLSTMs' input projections and recurrences, the transposed 1-D
convs, every 1×1, the attention's two products) pass through the precision's
rounding (``precision.py``): ``fp32`` is the reference, ``fp8`` the control
of the bf16 configuration, ``fp64`` computes everything in float64. The
STFT, the encoder conv, the decoder and the iSTFT stay in the dtype. The
recurrences are one loop over time, both directions at once (the DPRNN
reference's); the items go through in blocks of :data:`ROWS_A_BLOCK`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from bench_torch.precision import dtype, rounding
from bench_torch.reference.dprnn import _bilstm, _mm

ROWS_A_BLOCK = 4  # items the reference runs at once, to bound its memory (xw [2, B·T, F−3, 4H])
MEAN_FRAMES = 753  # STFT frames of the traffic's mean 6 s at 8 kHz (n_fft 256, hop 64)


def _widths(cfg: dict) -> tuple[int, int, int]:
    """``(F, E, D / heads)``: bins, Q and K channels a head, V channels a head."""
    freqs = cfg["n_fft"] // 2 + 1
    return freqs, -(-cfg["qk_dim"] // freqs), cfg["d_model"] // cfg["heads"]


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, by the name the port's ``state_dict`` uses."""
    d, h, taps, heads, s = cfg["d_model"], cfg["hidden"], cfg["kernel"], cfg["heads"], cfg["num_speakers"]
    freqs, e, dv = _widths(cfg)
    shapes = {"conv.kernel": (3, 3, 2, d), "conv.bias": (d,),
              "conv_norm.gamma": (d,), "conv_norm.beta": (d,)}
    for i in range(cfg["blocks"]):
        pre = f"block_{i}."
        for part in ("intra", "inter"):
            shapes.update({
                pre + f"{part}_norm.gamma": (d,), pre + f"{part}_norm.beta": (d,),
                pre + f"{part}_rnn.cells.kernel": (2, taps * d, 4 * h),
                pre + f"{part}_rnn.cells.recurrent_kernel": (2, h, 4 * h),
                pre + f"{part}_rnn.cells.bias": (2, 4 * h),
                pre + f"{part}_linear.kernel": (taps, 2 * h, d), pre + f"{part}_linear.bias": (d,),
            })
        for name, n, width in (("q", heads, e), ("k", heads, e), ("v", heads, dv), ("proj", 1, d)):
            at = pre + f"attn_{name}."
            shapes.update({
                at + "conv.kernel": (1, d, n * width), at + "conv.bias": (n * width,),
                at + "alpha": (n,), at + "gamma": (n, width, freqs), at + "beta": (n, width, freqs),
            })
    shapes.update({"deconv.kernel": (3, 3, d, 2 * s), "deconv.bias": (2 * s,)})
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random fp32 weights from the seed, made on ``device`` in one draw, as
    the DPRNN reference makes its own: kernels normal with variance
    1/fan-in (an LSTM's over its input or its hidden units, a conv's over
    its taps and input channels); biases and norm shifts normal with std
    0.1, plus 1 on each LSTM's forget-gate slice; norm scales 1 +
    0.2·normal; PReLU slopes 0.25 + 0.05·normal."""
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
            w *= 1.0 / math.sqrt(math.prod(shape[:-1]))
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
    """STFT frames of ``samples`` with the fade pads: ⌈(samples + n_fft − hop) / hop⌉."""
    n, hop = cfg["n_fft"], cfg["hop"]
    return -(-(np.asarray(samples) + 2 * (n - hop) - n + hop) // hop)


def flops_per_frame(cfg: dict) -> int:
    """Multiply-adds (two operations each) of the products an STFT frame,
    counted from the widths: the encoder conv; in each block, the intra
    BiLSTM (input and recurrent products, both directions) and its
    transposed conv over the frame's F − I + 1 windows; the inter BiLSTM and
    its transposed conv over F rows at (T − I + 1) / T windows a frame; the
    attention's 1×1s and, over T frames, its QKᵀ and PV; the decoder. T is
    :data:`MEAN_FRAMES`, the traffic's mean of 6 s (3,887,600,352): a batch
    at 2 s (T = 253) needs 2.35% fewer operations a frame, one at 10 s (T =
    1,253) 1.99% more (the attention's products grow with T). The STFT and
    iSTFT are left out (0.01%)."""
    d, h, taps, heads, s = cfg["d_model"], cfg["hidden"], cfg["kernel"], cfg["heads"], cfg["num_speakers"]
    freqs, e, dv = _widths(cfg)
    t = MEAN_FRAMES
    lstm = 2 * (2 * taps * d * 4 * h + 2 * h * 4 * h)  # a window, both directions
    linear = 2 * 2 * h * taps * d  # a window's transposed-conv products
    intra = (freqs - taps + 1) * (lstm + linear)
    inter = freqs * (t - taps + 1) * (lstm + linear) // t
    projections = freqs * 2 * d * (2 * heads * e + heads * dv + d)
    products = 2 * t * freqs * heads * (e + dv)
    block = intra + inter + projections + products
    return freqs * 2 * 2 * 9 * d + cfg["blocks"] * block + freqs * 2 * d * 9 * 2 * s


def _window(n: int, like: torch.Tensor) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64)
    return torch.sqrt(0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).to(like.device, like.dtype)


def _dft(n: int, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)`` ``[n, n/2 + 1]``: cos(2π m k / n) and sin(2π m k / n)."""
    m = torch.arange(n, dtype=torch.float64)[:, None]
    k = torch.arange(n // 2 + 1, dtype=torch.float64)[None, :]
    ang = 2 * math.pi * m * k / n
    return torch.cos(ang).to(like.device, like.dtype), torch.sin(ang).to(like.device, like.dtype)


def _stft(x: torch.Tensor, n: int, hop: int) -> torch.Tensor:
    """``[B, samples]`` → (real, imag) ``[B, 2, T, n/2 + 1]``."""
    pad = n - hop
    count = int(frames({"n_fft": n, "hop": hop}, x.shape[1]))
    total = (count - 1) * hop + n
    x = F.pad(x, (pad, total - x.shape[1] - pad))
    cols = x.unfold(1, n, hop) * _window(n, x)  # [B, T, n]
    cos, sin = _dft(n, x)
    return torch.stack([cols @ cos, -(cols @ sin)], dim=1)


def _istft(re: torch.Tensor, im: torch.Tensor, n: int, hop: int, samples: int) -> torch.Tensor:
    """``[R, T, n/2 + 1]`` real and imaginary parts → ``[R, samples]``."""
    cos, sin = _dft(n, re)
    scale = torch.full((n // 2 + 1,), 2.0 / n, dtype=re.dtype, device=re.device)
    scale[0] = scale[-1] = 1.0 / n
    im = im.clone()
    im[..., 0] = 0
    im[..., -1] = 0
    cols = (re * scale) @ cos.T - (im * scale) @ sin.T  # [R, T, n]
    w = _window(n, re)
    power = torch.zeros(hop, dtype=re.dtype, device=re.device)
    for j in range(n // hop):
        power += w[j * hop:(j + 1) * hop].square()
    cols = cols * (w / power.repeat(n // hop))
    rows, count, _ = cols.shape
    out = cols.new_zeros(rows, (count - 1) * hop + n)
    for t in range(count):
        out[:, t * hop:t * hop + n] += cols[:, t]
    return out[:, n - hop:n - hop + samples]


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def _ln_channels(x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """``LayerNormalization4D`` over ``[B, C, T, F]``: over C at each (t, f)."""
    mean = x.mean(dim=1, keepdim=True)
    var = (x - mean).square().mean(dim=1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma[:, None, None] + beta[:, None, None]


def _ln_plane(x: torch.Tensor, gamma, beta, eps: float) -> torch.Tensor:
    """``LayerNormalization4DCF`` over ``[B, C, T, F]``: over (C, F) at each t;
    ``gamma``, ``beta`` ``[C, F]``."""
    mean = x.mean(dim=(1, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * gamma[:, None, :] + beta[:, None, :]


def _conv1x1(x: torch.Tensor, kernel, bias, precision: str) -> torch.Tensor:
    """``[B, C, T, F]`` × ``kernel [1, C, C']`` → ``[B, C', T, F]``."""
    return _mm(x.permute(0, 2, 3, 1), kernel[0], precision).permute(0, 3, 1, 2) + bias[:, None, None]


def _sequence_half(x: torch.Tensor, w: dict, pre: str, cfg: dict, precision: str) -> torch.Tensor:
    """A BiLSTM half over the last axis of ``x [B, C, N, L]`` (N rows of L
    steps an item), with its transposed conv back to L; ``[B, C, N, L]``."""
    q = rounding(precision)
    b, c, n, length = x.shape
    taps = cfg["kernel"]
    p = length - taps + 1
    seq = x.permute(0, 2, 3, 1).reshape(b * n, length, c)
    rows = torch.stack([seq[:, k:k + p] for k in range(taps)], dim=2).reshape(b * n, p, taps * c)
    y = _bilstm(rows, w[pre + "rnn.cells.kernel"], w[pre + "rnn.cells.recurrent_kernel"],
                w[pre + "rnn.cells.bias"], precision)  # [B·N, P, 2H]
    weight = w[pre + "linear.kernel"].permute(1, 2, 0)  # [2H, C, I]: torch's layout
    y = F.conv_transpose1d(q(y.transpose(1, 2)), q(weight), w[pre + "linear.bias"])  # [B·N, C, L]
    return y.reshape(b, n, c, length).permute(0, 2, 1, 3)


def _projection(x: torch.Tensor, w: dict, at: str, l: int, width: int, eps: float,
                precision: str) -> torch.Tensor:
    """Head ``l`` of the projection ``at``: LN₍width,F₎(PReLU_l(1×1)) → ``[B, width, T, F]``."""
    cols = slice(l * width, (l + 1) * width)
    y = _conv1x1(x, w[at + "conv.kernel"][:, :, cols], w[at + "conv.bias"][cols], precision)
    return _ln_plane(_prelu(y, w[at + "alpha"][l]), w[at + "gamma"][l], w[at + "beta"][l], eps)


def _attention(x: torch.Tensor, w: dict, pre: str, cfg: dict, precision: str) -> torch.Tensor:
    b, d, t, f = x.shape
    heads, eps = cfg["heads"], cfg["eps"]
    _, e, dv = _widths(cfg)
    outs = []
    for l in range(heads):
        q = _projection(x, w, pre + "attn_q.", l, e, eps, precision).transpose(1, 2).reshape(b, t, -1)
        k = _projection(x, w, pre + "attn_k.", l, e, eps, precision).transpose(1, 2).reshape(b, t, -1)
        v = _projection(x, w, pre + "attn_v.", l, dv, eps, precision).transpose(1, 2)  # [B, T, dv, F]
        scores = _mm(q, k.transpose(1, 2), precision) / math.sqrt(q.shape[-1])
        o = _mm(torch.softmax(scores, dim=-1), v.reshape(b, t, -1), precision)
        outs.append(o.reshape(b, t, dv, f).transpose(1, 2))  # [B, dv, T, F]
    y = torch.cat(outs, dim=1)
    at = pre + "attn_proj."
    y = _prelu(_conv1x1(y, w[at + "conv.kernel"], w[at + "conv.bias"], precision), w[at + "alpha"][0])
    return _ln_plane(y, w[at + "gamma"][0], w[at + "beta"][0], eps)


def forward(w: dict, cfg: dict, mix: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` → ``[B, speakers, samples]``; ``w`` in the precision's dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, hop, eps, s = cfg["n_fft"], cfg["hop"], cfg["eps"], cfg["num_speakers"]
    bsz, samples = mix.shape
    std = mix.std(dim=1, keepdim=True)
    spec = _stft(mix / std, n, hop)  # [B, 2, T, F]
    x = F.conv2d(spec, w["conv.kernel"].permute(3, 2, 0, 1), w["conv.bias"], padding=1)
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    x = ((x - mean) / torch.sqrt(var + eps) * w["conv_norm.gamma"][:, None, None]
         + w["conv_norm.beta"][:, None, None])  # [B, D, T, F]
    for i in range(cfg["blocks"]):
        pre = f"block_{i}."
        h = _ln_channels(x, w[pre + "intra_norm.gamma"], w[pre + "intra_norm.beta"], eps)
        x = x + _sequence_half(h, w, pre + "intra_", cfg, precision)  # rows: frames; steps: bins
        h = _ln_channels(x, w[pre + "inter_norm.gamma"], w[pre + "inter_norm.beta"], eps)
        x = x + _sequence_half(h.transpose(2, 3), w, pre + "inter_", cfg, precision).transpose(2, 3)
        x = x + _attention(x, w, pre, cfg, precision)
    y = F.conv_transpose2d(x, w["deconv.kernel"].permute(2, 3, 0, 1), w["deconv.bias"], padding=1)
    t, f = y.shape[2], y.shape[3]
    y = y.reshape(bsz * s, 2, t, f)
    wav = _istft(y[:, 0], y[:, 1], n, hop, samples)
    return wav.reshape(bsz, s, samples) * std[:, :, None]


@torch.no_grad()
def separate(weights: dict, cfg: dict, mix: torch.Tensor, frame_lengths=None,
             precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]`` → ``[B, S, samples]``, in blocks of items.
    ``frame_lengths`` is unused: the deviation, GroupNorm and the attention
    see the padded item, as in the served model."""
    dt = dtype(precision)
    w = {k: v.to(dt) for k, v in weights.items()}
    return torch.cat([forward(w, cfg, mix[i:i + ROWS_A_BLOCK].to(dt), precision)
                      for i in range(0, mix.shape[0], ROWS_A_BLOCK)])
