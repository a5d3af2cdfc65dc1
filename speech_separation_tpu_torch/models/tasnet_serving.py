"""Conv-TasNet serving with the global layer norms folded into their consumers
(counterpart of ``models/tasnet_serving.py``).

gLN is an affine map with per-item scalars, ``n(x) = A · x + B`` with
``A = gamma / sigma`` and ``B = beta − mean · A``, so it folds exactly:

- into a following 1×1 conv ``W``: ``n @ W = (x @ gamma·W) / sigma + B @ W``;
- into a following depthwise conv: ``dw(n) = A · dw(x) + B · m``, where
  ``m[t, c] = Σ_k w[k, c] · inside(t + k·d − pad)`` corrects the "SAME"
  zero-padding (zero-padding ``n`` is not zero-padding ``x``);
- ``res_out`` and ``skip_out`` read the same input, so they run as one product
  with concatenated output channels.

:func:`fused_apply` computes the same function as ``ConvTasNet.forward`` over
the same parameters, in plain PyTorch, in fp32 or bf16. :func:`cuda_apply` is
the serving path with the whole TCN trunk in the ``tcn_trunk`` CUDA kernel
(``ops/tcn_cuda.py``), bf16 only; the encoder, input projection, mask head and
decoder stay PyTorch (cuDNN and cuBLAS), as the JAX package leaves them to XLA
around its Pallas trunk. Both take the fp32 module and read its parameters;
both serve the gLN topology only.

:func:`train_apply` is the differentiable counterpart of ``cuda_apply`` that
``make_time_domain_steps(pallas_trunk=True)`` trains through (the JAX kernel
branch's ``_forward``): the live fp32 parameters cast to bf16 inside, the
trunk in the training kernels (``ops/tcn_train_cuda.py``), so gradients reach
every parameter in fp32.
"""

from __future__ import annotations

import torch

from ..ops.tcn_cuda import stack_canonical, stack_tcn_weights, tcn_trunk_cuda, tcn_trunk_plain
from ..ops.tcn_train_cuda import tcn_trunk_train
from ..utils.profiling import span
from .tasnet import ConvTasNet, decode, depthwise, encode

__all__ = ["fused_apply", "cuda_apply", "train_apply"]


def _gln_affine(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Per-item gLN coefficients over (time, channels), fp32, one pass:
    ``(s [B], a [B, C], b [B, C])`` with ``s = 1/sigma``, ``a = gamma·s``,
    ``b = beta − mean·a``."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2))
    var = torch.clamp(x32.square().mean(dim=(1, 2)) - mean.square(), min=0.0)
    s = torch.rsqrt(var + 1e-8)
    a = gamma[None, :] * s[:, None]
    return s, a, beta[None, :] - mean[:, None] * a


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


def _folded_dot(x, sab, w, gamma, bias, dt):
    """``gLN_affine(x) @ w + bias`` with the normalisation folded into the
    product: ``x [B, T, C]`` in ``dt``, ``w [C, O]`` fp32, ``gamma`` the gLN's
    scale. Returns ``[B, T, O]`` in ``dt``."""
    s, _, b = sab
    out = x @ (gamma[:, None] * w).to(dt)
    bias2 = b @ w + bias[None, :]  # [B, O] fp32
    return (out.float() * s[:, None, None] + bias2[:, None, :]).to(dt)


def _params(model: ConvTasNet, live: bool = False) -> dict[str, torch.Tensor]:
    """The module's parameters in fp32, detached unless ``live``."""
    if not isinstance(model, ConvTasNet):
        raise TypeError(f"expected a ConvTasNet, got {type(model).__name__}")
    return {name: p.float() if live else p.detach().float() for name, p in model.named_parameters()}


def _encode_and_project(p, mix, win, dt):
    """Encoder filterbank, and the input gLN folded into the 1×1 bottleneck
    projection: ``(feats [B, K, N], h [B, K, bottleneck])`` in ``dt``."""
    feats = encode(mix, p["encoder.kernel"].to(dt), p["encoder.bias"].to(dt), win)
    sab = _gln_affine(feats, p["input_norm.gamma"], p["input_norm.beta"])
    h = _folded_dot(feats, sab, p["input_proj.kernel"][0], p["input_norm.gamma"],
                    p["input_proj.bias"], dt)
    return feats, h


def _mask_and_decode(p, feats, skip_sum, num_speakers, enc_dim, win, samples, dt):
    """PReLU → mask projection → mask × feats → the shared transposed decoder."""
    b, k = feats.shape[:2]
    mpre = _prelu(skip_sum.to(dt), p["mask_prelu.alpha"])
    masks = torch.sigmoid(mpre @ p["mask_proj.kernel"][0].to(dt) + p["mask_proj.bias"].to(dt))
    masked = masks.view(b, k, num_speakers, enc_dim) * feats[:, :, None, :]
    masked = masked.transpose(1, 2).reshape(b * num_speakers, k, enc_dim)
    wav = decode(masked, p["decoder.kernel"].to(dt), p["decoder.bias"].to(dt), win)
    return wav.reshape(b, num_speakers, -1).float()[:, :, :samples]


def _check_mix(model: ConvTasNet, mix: torch.Tensor) -> None:
    if model.causal:
        raise ValueError(
            "the folded serving paths implement the gLN topology; a causal (cLN) "
            "ConvTasNet runs through its own forward"
        )
    if mix.dim() != 2 or mix.shape[1] % model.stride:
        raise ValueError(
            f"mix {tuple(mix.shape)}: expected [B, samples] with samples a multiple of "
            f"win//2 = {model.stride}"
        )


@torch.no_grad()
def fused_apply(model: ConvTasNet, mix: torch.Tensor, *, dtype: torch.dtype | None = torch.bfloat16):
    """``ConvTasNet`` forward with gLN folded, plain PyTorch: ``mix [B,
    samples]`` (a multiple of ``win // 2``) → fp32 ``[B, S, samples]``.
    ``dtype=None`` computes in fp32."""
    _check_mix(model, mix)
    dt = dtype or torch.float32
    p = _params(model)
    feats, h = _encode_and_project(p, mix, model.win, dt)
    k = feats.shape[1]
    t_idx = torch.arange(k, device=mix.device)[:, None]
    skip_sum = torch.zeros_like(h)
    for r in range(model.repeats):
        for x in range(model.blocks):
            pre = f"tcn_{r}_{x}."
            dil = 2**x
            t1 = _prelu(h @ p[pre + "expand.kernel"][0].to(dt) + p[pre + "expand.bias"].to(dt),
                        p[pre + "prelu1.alpha"])
            # norm1 folded into the depthwise conv: dw(n1) = A1 · dw(t1) + B1 · m + bias
            _, a1, b1 = _gln_affine(t1, p[pre + "norm1.gamma"], p[pre + "norm1.beta"])
            w_dw = p[pre + "depthwise.kernel"]
            dwy = depthwise(t1, w_dw.to(dt), dil)
            pad_left = (model.kernel - 1) * dil // 2
            m = 0
            for j in range(model.kernel):
                src = t_idx + (j * dil - pad_left)
                m = m + w_dw[j, 0][None, :] * ((src >= 0) & (src < k))  # [K, hidden] fp32
            t2 = _prelu(
                (dwy.float() * a1[:, None, :] + b1[:, None, :] * m[None]
                 + p[pre + "depthwise.bias"][None, None, :]).to(dt),
                p[pre + "prelu2.alpha"],
            )
            # norm2 folded into one combined res|skip product
            sab = _gln_affine(t2, p[pre + "norm2.gamma"], p[pre + "norm2.beta"])
            w_cat = torch.cat([p[pre + "res_out.kernel"][0], p[pre + "skip_out.kernel"][0]], dim=1)
            bias_cat = torch.cat([p[pre + "res_out.bias"], p[pre + "skip_out.bias"]])
            rs = _folded_dot(t2, sab, w_cat, p[pre + "norm2.gamma"], bias_cat, dt)
            h = h + rs[..., : model.bottleneck]
            skip_sum = skip_sum + rs[..., model.bottleneck :]
    return _mask_and_decode(p, feats, skip_sum, model.num_speakers, model.enc_dim, model.win,
                            mix.shape[1], dt)


@torch.no_grad()
def cuda_apply(model: ConvTasNet, mix: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """``ConvTasNet`` forward with the TCN trunk in the ``tcn_trunk`` kernel
    (bf16, the kernel's precision contract): ``mix [B, samples]`` (a multiple
    of ``win // 2``) → fp32 ``[B, S, samples]``. ``plain=True`` runs the
    trunk's plain version instead, on any device: the reference a GPU run is
    compared with. Raises on a causal model."""
    _check_mix(model, mix)
    dt = torch.bfloat16
    with span("tasnet.weights"):  # restacked every call
        p = _params(model)
        stacks = stack_tcn_weights(p, blocks=model.blocks, repeats=model.repeats)
    feats, h = _encode_and_project(p, mix, model.win, dt)
    trunk = tcn_trunk_plain if plain else tcn_trunk_cuda
    skip_sum = trunk(h, *stacks, dils=_dilations(model), taps=model.kernel)
    return _mask_and_decode(p, feats, skip_sum, model.num_speakers, model.enc_dim, model.win,
                            mix.shape[1], dt)


def _dilations(model: ConvTasNet) -> tuple[int, ...]:
    return tuple(2**x for _ in range(model.repeats) for x in range(model.blocks))


def train_apply(model: ConvTasNet, mix: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """``ConvTasNet`` forward for training, differentiable in the module's
    parameters, with the TCN trunk in the training kernels (bf16, the
    kernels' contract): ``mix [B, samples]`` (a multiple of ``win // 2``) →
    fp32 ``[B, S, samples]``. ``plain=True`` runs the trunk's plain versions
    on any device. Raises on a causal model."""
    _check_mix(model, mix)
    dt = torch.bfloat16
    p = _params(model, live=True)
    feats, h = _encode_and_project(p, mix, model.win, dt)
    arrays = stack_canonical(p, blocks=model.blocks, repeats=model.repeats)
    skip_sum = tcn_trunk_train(h, *arrays, dils=_dilations(model), taps=model.kernel, plain=plain)
    return _mask_and_decode(p, feats, skip_sum, model.num_speakers, model.enc_dim, model.win,
                            mix.shape[1], dt)
