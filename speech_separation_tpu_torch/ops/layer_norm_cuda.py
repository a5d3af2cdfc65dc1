"""Residual add and LayerNorm in one pass (``csrc/residual_layer_norm.cu``).

:func:`residual_layer_norm` takes the fp32 stream ``x [..., d]``, an optional
branch ``y`` of the same shape (bf16 or fp32) and the norm's ``gamma`` and
``beta``, and returns ``(x + y, LN(x + y))``, the normed rows in
``out_dtype`` (bf16 or fp32), eps ``eps`` (default :data:`EPS`). With no
``y`` it returns ``x`` and ``LN(x)``. The port's SepFormer chains its pre-LN
layers through it (``models/sepformer.py``): each residual add with the
LayerNorm of the next product, the rows written in that product's dtype.
TF-GridNet (``models/tfgridnet.py``) adds each half's branch to its
channels-last stream and normalises the next half's input over the channels
with it, at eps 1e-5. The kernel has no JAX counterpart.

The kernel runs on a CUDA tensor when autograd does not record, and writes
``x + y`` in place over ``x``: a caller hands over ``x`` and reads the sum
from the result. :func:`residual_layer_norm_plain` (``x + y.float()``,
``F.layer_norm``, a cast: new tensors) runs where ``dispatch.use_plain``
says (a CPU tensor, or inside ``plain_versions()``), and wherever autograd
records (grad mode on and a tensor given that requires a gradient), so
training keeps PyTorch's operations and their gradients. Otherwise the
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .dispatch import use_plain

__all__ = ["EPS", "MAX_DIM", "residual_layer_norm", "residual_layer_norm_plain"]

EPS = 1e-6  # SepFormer's; the kernel takes any eps as an argument
MAX_DIM = 1024  # the kernel's kMaxDim: a row of at most 32 values a lane in registers
_DTYPES = (torch.bfloat16, torch.float32)  # of the branch y and of the normed rows


def residual_layer_norm_plain(x: torch.Tensor, y: torch.Tensor | None, gamma: torch.Tensor,
                              beta: torch.Tensor, out_dtype: torch.dtype, eps: float = EPS):
    """``(x + y.float(), F.layer_norm(x + y.float()) in out_dtype)``; ``y``
    None adds nothing and returns ``x`` itself."""
    s = x if y is None else x + y.float()
    h = F.layer_norm(s, gamma.shape, gamma.float(), beta.float(), eps)
    return s, h.to(out_dtype)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def residual_layer_norm(x: torch.Tensor, y: torch.Tensor | None, gamma: torch.Tensor,
                        beta: torch.Tensor, out_dtype: torch.dtype, eps: float = EPS):
    """``(x + y, LN(x + y))`` over the last axis of ``x``, the second in
    ``out_dtype``; on the kernel's path the first is ``x``, overwritten."""
    if use_plain(x) or _records(x, y, gamma, beta):
        return residual_layer_norm_plain(x, y, gamma, beta, out_dtype, eps)
    d = x.shape[-1]
    if x.dtype != torch.float32:
        raise TypeError(f"residual_layer_norm: the stream x must be fp32, got {x.dtype}")
    if y is not None and (y.dtype not in _DTYPES or y.shape != x.shape):
        raise TypeError(f"residual_layer_norm: y must be bf16 or fp32 of x's shape "
                        f"{tuple(x.shape)}, got {y.dtype} {tuple(y.shape)}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"residual_layer_norm: writes bf16 or fp32, not {out_dtype}")
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"residual_layer_norm: gamma and beta must be [{d}], got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    if not (x.is_contiguous() and (y is None or y.is_contiguous())):
        raise ValueError("residual_layer_norm: x and y must be contiguous")
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"residual_layer_norm: rows of 1 to {MAX_DIM} values, got {d}")
    rows = x.numel() // d
    if rows >= 2**31:
        raise ValueError(f"residual_layer_norm: at most 2**31 - 1 rows, got {rows}")
    if x.device.type != "cuda" or any(t.device != x.device for t in (y, gamma, beta)
                                      if t is not None):
        raise ValueError(f"residual_layer_norm: x, y, gamma and beta on one CUDA device, "
                         f"got x on {x.device}")
    gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if rows:
        with torch.cuda.device(x.device):
            code = _build.library().sst_residual_layer_norm(
                x.data_ptr(), None if y is None else y.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), out.data_ptr(), rows, d,
                int(y is not None and y.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                eps, torch.cuda.current_stream().cuda_stream,
            )
        _build.check(code, "residual_layer_norm")
        residual_layer_norm.launches += 1
    return x, out


residual_layer_norm.launches = 0
