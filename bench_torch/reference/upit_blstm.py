"""Plain reference of the uPIT BLSTM separator, in plain PyTorch.

The spectral-domain baseline of Kolbæk et al. 2017 as the upstream notebook
builds it (jsjs4013/Speech-Separation-Project-with-AI, ``uPIT_baseline.ipynb``
cells 27 to 29 and 38 to 39): STFT 256/128 with a symmetric Blackman window
and fade padding; ``Dense(hidden, tanh)``; ``num_layers`` bidirectional LSTMs
(gates i, f, g, o; sigmoid, tanh), each followed by dropout in training; one
ReLU mask head a speaker, times the mixture magnitude; the mixture's phase;
the inverse STFT with the biorthogonal synthesis window and overlap-add.
Training minimises the phase-sensitive-mask PIT loss (squared error over the
valid frames, divided by the length, the best permutation, summed over the
batch) with Adam (optax's semantics) on an exponential-decay schedule.

It imports nothing of the program and takes no weights from it: the
weights come from :func:`make_weights` and the seed. Every product is a
matmul whose two operands pass through the precision's rounding
(``precision.py``): ``fp32`` is the reference, ``tf32`` the control. The
recurrences are one loop over time, both directions at once. ``fp64``
computes everything in float64: a witness above the reference.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from bench_torch.precision import dtype, rounding

_EPS = 1e-12


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter, by the name the port's ``state_dict`` uses."""
    f_in, hidden, f_out = cfg["input_size"], cfg["hidden"], cfg["output_size"]
    shapes = {"input_proj.kernel": (f_in, hidden), "input_proj.bias": (hidden,)}
    for i in range(cfg["num_layers"]):
        width = hidden if i == 0 else 2 * hidden
        shapes[f"bilstm_{i}.cells.kernel"] = (2, width, 4 * hidden)
        shapes[f"bilstm_{i}.cells.recurrent_kernel"] = (2, hidden, 4 * hidden)
        shapes[f"bilstm_{i}.cells.bias"] = (2, 4 * hidden)
    for s in range(cfg["num_speakers"]):
        shapes[f"heads.mask_head_{s}.kernel"] = (2 * hidden, f_out)
        shapes[f"heads.mask_head_{s}.bias"] = (f_out,)
    return shapes


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Random fp32 weights from the seed, made on ``device`` in one draw:
    kernels normal with variance 1/fan-in, biases normal with std 0.1 (plus
    1 on each LSTM's forget-gate slice, Keras's ``unit_forget_bias``)."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    flat = torch.randn(total, generator=gen, device=device)
    weights, at = {}, 0
    hidden = cfg["hidden"]
    for name, shape in shapes.items():
        n = math.prod(shape)
        w = flat[at:at + n].view(shape).clone()
        at += n
        if name.endswith("bias"):
            w *= 0.1
            if ".cells." in name:
                w[..., hidden:2 * hidden] += 1.0
        else:
            w *= 1.0 / math.sqrt(shape[-2])
        weights[name] = w
    return weights


def frames(cfg: dict, samples):
    """STFT frames of ``samples`` (fade padding on both sides): the model's
    true frame counts."""
    size, shift = cfg["stft_size"], cfg["stft_shift"]
    return -(-(np.asarray(samples) + size - shift) // shift)


def flops_per_frame(cfg: dict) -> int:
    """Multiply-adds (two operations each) of the mask network's products a
    frame, counted from the widths: the input Dense, each BiLSTM layer's
    input and recurrent products in both directions, the mask heads."""
    f_in, hidden, f_out = cfg["input_size"], cfg["hidden"], cfg["output_size"]
    total = 2 * f_in * hidden
    for i in range(cfg["num_layers"]):
        width = hidden if i == 0 else 2 * hidden
        total += 2 * (2 * width * 4 * hidden + 2 * hidden * 4 * hidden)
    return total + cfg["num_speakers"] * 2 * (2 * hidden) * f_out


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
        q = ctx.q
        qg = q(g)
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


def _blackman(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    x = 2.0 * np.pi * n / (size - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)


def _synthesis_window(size: int, shift: int) -> np.ndarray:
    """The notebook's biorthogonal synthesis window (Krueger eq. A.92), with
    its sum of squares skipping index ``size - 1`` and its ``1/size`` undone."""
    win = _blackman(size)
    sq = np.zeros(shift)
    for r in range(shift):
        for k in range(size // shift + 1):
            idx = r + shift * k
            if idx + 1 < size:
                sq[r] += win[idx] ** 2
    return win / np.tile(sq, size // shift)


def _bases(cfg: dict, device, dt=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Analysis ``[size, 2·bins]`` (windowed cos, −sin) and synthesis
    ``[2·bins, size]`` (the real inverse DFT times the synthesis window) bases."""
    size, shift = cfg["stft_size"], cfg["stft_shift"]
    bins = size // 2 + 1
    n = np.arange(size)[:, None]
    f = np.arange(bins)[None, :]
    ang = 2.0 * np.pi * n * f / size
    win = _blackman(size)[:, None]
    analysis = np.concatenate([win * np.cos(ang), -win * np.sin(ang)], axis=1)
    scale = np.full((bins, 1), 2.0 / size)
    scale[0] = scale[-1] = 1.0 / size
    ws = _synthesis_window(size, shift)[None, :]
    re = scale * np.cos(ang.T) * ws
    im = -scale * np.sin(ang.T) * ws
    im[0] = im[-1] = 0.0
    synthesis = np.concatenate([re, im], axis=0)
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return as_t(analysis), as_t(synthesis)


def stft(wave: torch.Tensor, cfg: dict, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(re, im)``, each ``[..., frames, bins]``."""
    size, shift = cfg["stft_size"], cfg["stft_shift"]
    edge = size - shift
    padded = torch.nn.functional.pad(wave.to(dtype(precision)), (edge, edge))
    total = padded.shape[-1]
    count = -(-(total - size + shift) // shift)
    padded = torch.nn.functional.pad(padded, (0, count * shift + size - shift - total))
    framed = padded.unfold(-1, size, shift)
    analysis, _ = _bases(cfg, wave.device, dtype(precision))
    flat = _mm(framed, analysis, precision)
    bins = size // 2 + 1
    return flat[..., :bins], flat[..., bins:]


def istft(re: torch.Tensor, im: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    """Overlap-add inverse of :func:`stft`, fade padding cropped."""
    size, shift = cfg["stft_size"], cfg["stft_shift"]
    _, synthesis = _bases(cfg, re.device, dtype(precision))
    framed = _mm(torch.cat([re, im], dim=-1), synthesis, precision)  # [..., T, size]
    *lead, count, _ = framed.shape
    k = size // shift
    chunks = framed.reshape(*lead, count, k, shift)
    out = framed.new_zeros((*lead, count + k - 1, shift))
    for c in range(k):
        out[..., c:c + count, :] += chunks[..., c, :]
    out = out.reshape(*lead, (count + k - 1) * shift)
    edge = size - shift
    return out[..., edge:out.shape[-1] - edge]


def _bilstm(x: torch.Tensor, kernel, recurrent, bias, precision: str) -> torch.Tensor:
    """``[B, T, F]`` → ``[B, T, 2H]``: direction 0 forwards in time, 1 backwards."""
    b, t, _ = x.shape
    hidden = recurrent.shape[1]
    xw = torch.stack([_mm(x, kernel[d], precision) + bias[d] for d in range(2)])  # [2, B, T, 4H]
    h = x.new_zeros((2, b, hidden))
    c = x.new_zeros((2, b, hidden))
    outs = [[None] * t for _ in range(2)]
    for s in range(t):
        z = torch.stack([xw[0, :, s], xw[1, :, t - 1 - s]]) + _mm(h, recurrent, precision)
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs[0][s] = h[0]
        outs[1][t - 1 - s] = h[1]
    return torch.cat([torch.stack(outs[0], dim=1), torch.stack(outs[1], dim=1)], dim=-1)


def mask_network(weights: dict, cfg: dict, mag: torch.Tensor, precision: str,
                 dropout: torch.Generator | None = None) -> torch.Tensor:
    """``[B, T, F]`` magnitude → ``[B, T, S·F]`` masked magnitudes; dropout
    after each BiLSTM layer with bits from ``dropout`` (none without it)."""
    h = torch.tanh(_mm(mag, weights["input_proj.kernel"], precision) + weights["input_proj.bias"])
    rate = cfg["dropout"]
    for i in range(cfg["num_layers"]):
        cells = f"bilstm_{i}.cells"
        h = _bilstm(h, weights[f"{cells}.kernel"], weights[f"{cells}.recurrent_kernel"],
                    weights[f"{cells}.bias"], precision)
        if dropout is not None and rate > 0.0:
            kept = torch.rand(h.shape, generator=dropout, device=h.device) < 1.0 - rate
            h = torch.where(kept, h / (1.0 - rate), 0.0)
    heads = [torch.relu(_mm(h, weights[f"heads.mask_head_{s}.kernel"], precision)
                        + weights[f"heads.mask_head_{s}.bias"]) * mag
             for s in range(cfg["num_speakers"])]
    return torch.cat(heads, dim=-1)


def _cast(weights: dict, precision: str) -> dict:
    return {k: v.to(dtype(precision)) for k, v in weights.items()}


@torch.no_grad()
def separate(weights: dict, cfg: dict, mix: torch.Tensor, frame_lengths: torch.Tensor,
             precision: str = "fp32") -> torch.Tensor:
    """``mix [B, samples]``, true frame counts ``[B]`` → ``[B, S, samples']``
    (frames past an utterance's length zeroed before the overlap-add)."""
    re, im = stft(mix, cfg, precision)
    mag = torch.sqrt(re * re + im * im)
    inv = 1.0 / torch.clamp(mag, min=_EPS)
    cos, sin = re * inv, im * inv
    preds = mask_network(_cast(weights, precision), cfg, mag, precision)
    t, f = mag.shape[-2:]
    live = (torch.arange(t, device=mix.device)[None, :]
            < torch.as_tensor(frame_lengths, device=mix.device)[:, None]).to(mag.dtype)[..., None]
    outs = []
    for s in range(cfg["num_speakers"]):
        masked = preds[..., s * f:(s + 1) * f] * live
        outs.append(istft(masked * cos, masked * sin, cfg, precision))
    return torch.stack(outs, dim=1)


def pit_loss(weights: dict, cfg: dict, mix, sources, frame_lengths, precision: str,
             dropout: torch.Generator | None) -> torch.Tensor:
    """The phase-sensitive-mask PIT loss of one batch, summed over it."""
    b, n_src, samples = sources.shape
    re, im = stft(torch.cat([mix.reshape(b, samples), sources.reshape(b * n_src, samples)]),
                  cfg, precision)
    m_re, m_im = re[:b], im[:b]
    s_re, s_im = re[b:].reshape(b, n_src, *re.shape[1:]), im[b:].reshape(b, n_src, *im.shape[1:])
    mag = torch.sqrt(m_re * m_re + m_im * m_im)
    inv = 1.0 / torch.clamp(mag, min=_EPS)
    labels = (m_re[:, None] * s_re + m_im[:, None] * s_im) * inv[:, None]  # [B, S, T, F]
    preds = mask_network(weights, cfg, mag, precision, dropout)
    t, f = mag.shape[-2:]
    lengths = torch.as_tensor(frame_lengths, device=mix.device)
    live = (torch.arange(t, device=mix.device)[None, :] < lengths[:, None]).to(mag.dtype)
    preds = preds.reshape(b, t, n_src, f).movedim(2, 1) * live[:, None, :, None]  # [B, S, T, F]
    costs = (preds[:, :, None] - labels[:, None]).square().sum(dim=(3, 4))  # [B, S_pred, S_label]
    per_perm = torch.stack([sum(costs[:, k, p[k]] for k in range(n_src))
                            for p in itertools.permutations(range(n_src))], dim=1)
    return (per_perm.min(dim=1).values / lengths.to(mag.dtype)).sum()


class Adam:
    """optax's Adam on ``exponential_decay(lr, steps, rate, staircase=True)``:
    the rate read at the update count before the update, the bias
    corrections in float32, eps outside the square root."""

    def __init__(self, params: dict, cfg: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.cfg = params, cfg
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def rate(self, count: int) -> float:
        return self.cfg["learning_rate"] * self.cfg["lr_decay_rate"] ** math.floor(
            count / self.cfg["lr_decay_steps"])

    @torch.no_grad()
    def update(self, grads: dict) -> None:
        lr = self.rate(self.count)
        c1 = float(np.float32(1) - np.float32(self.b1) ** (self.count + 1))
        c2 = float(np.float32(1) - np.float32(self.b2) ** (self.count + 1))
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            p.add_(self.mu[k] / c1 / (torch.sqrt(self.nu[k] / c2) + self.eps) * -lr)
        self.count += 1


class Trainer:
    """The reference training step, in the program's place or beside it:
    ``step(mix, sources, frame_lengths) -> loss``; dropout bits from a
    generator on the device seeded with the seed, drawn as the program's
    training forward draws them."""

    def __init__(self, weights: dict, cfg: dict, seed: int, precision: str = "fp32"):
        device = next(iter(weights.values())).device
        self.params = {k: v.detach().to(dtype(precision)).clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.cfg, self.precision = cfg, precision
        self.adam = Adam(self.params, cfg)
        self.dropout = torch.Generator(device=device).manual_seed(int(seed))
        self.last_grads: dict[str, torch.Tensor] = {}

    def step(self, mix, sources, frame_lengths) -> torch.Tensor:
        loss = pit_loss(self.params, self.cfg, mix, sources, frame_lengths, self.precision,
                        self.dropout)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        self.last_grads = dict(zip(self.params, grads))
        self.adam.update(self.last_grads)
        return loss.detach()

    def first_grad_norms(self) -> dict[str, float]:
        """Each leaf's gradient norm, worked out from Adam's first moment after one step."""
        return {k: (mu / (1.0 - self.adam.b1)).double().norm().item() for k, mu in self.adam.mu.items()}

    def parameters(self) -> dict[str, torch.Tensor]:
        return self.params

    def snapshot(self):
        return ({k: v.detach().clone() for k, v in self.params.items()},
                {k: v.clone() for k, v in self.adam.mu.items()},
                {k: v.clone() for k, v in self.adam.nu.items()}, self.adam.count)

    @torch.no_grad()
    def restore(self, snap) -> None:
        params, mu, nu, count = snap
        for k in self.params:
            self.params[k].copy_(params[k])
            self.adam.mu[k].copy_(mu[k])
            self.adam.nu[k].copy_(nu[k])
        self.adam.count = count
