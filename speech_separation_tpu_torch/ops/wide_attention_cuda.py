"""Self-attention at head widths that flash attention lacks
(``csrc/wide_attention.cu``), softmax(q kᵀ / √d) v over ``[N, L, d]``, with
no mask.

TF-GridNet's full-band attention (``models/tfgridnet.py``) flattens a frame's
(channel, frequency) plane into a head: q and k rows of 4 × 129 = 516
values, v rows of 32 × 129 = 4,128. SDPA's flash kernel stops at head size
256 (``ops/attention.py``), so these run here:

- :func:`wide_attention_scores` writes the probabilities ``softmax(q kᵀ ·
  d^-1/2)`` ``[N, L, L]`` in bf16, in one launch of the hand-written kernel
  (tensor-core products, fp32 row maximum and sum);
- :func:`wide_attention` multiplies them by ``v`` with ``torch.matmul``, a
  plain large product.

On a CUDA tensor the wrapper launches the kernel or raises: it takes bf16
``q`` and ``k`` of one shape on one device, with autograd not recording (the
kernel has no backward), and never falls back to the plain version or to
SDPA. A CPU tensor, or a call inside ``ops.plain_versions()``, runs
:func:`wide_attention_plain` (``ops/dispatch.py``), which writes the scores,
softmax and product out in fp32 and is differentiable. The kernel has no JAX
counterpart.
"""

from __future__ import annotations

import torch

from .. import _build
from .dispatch import use_plain

__all__ = [
    "wide_attention",
    "wide_attention_plain",
    "wide_attention_scores",
    "wide_attention_scores_plain",
]


def wide_attention_scores_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ · d^-1/2)`` over ``[N, L, d]`` in fp32, whatever the inputs' dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(scores, dim=-1)


def wide_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The scores, their softmax and the product with ``v`` written out, in
    fp32 whatever the inputs' dtype; the result in ``v``'s dtype."""
    return torch.matmul(wide_attention_scores_plain(q, k), v.float()).to(v.dtype)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def wide_attention_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q, k [N, L, d]`` → the probabilities ``[N, L, L]``: bf16 from the
    kernel on a GPU, fp32 from the plain version."""
    if use_plain(q):
        return wide_attention_scores_plain(q, k)
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(f"wide_attention: the kernel takes bf16 q and k, got {q.dtype} and {k.dtype} "
                        "(serve in bf16, or run the plain version inside ops.plain_versions())")
    if q.dim() != 3 or q.shape != k.shape or q.shape[-1] < 1:
        raise ValueError(f"wide_attention: q and k [N, L, d] of one shape, got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    if _records(q, k):
        raise RuntimeError("wide_attention: the scores kernel has no backward; train on the plain "
                           "version (a CPU tensor, or inside ops.plain_versions())")
    if q.device.type != "cuda" or k.device != q.device:
        raise ValueError(f"wide_attention: q and k on one CUDA device, got {q.device} and {k.device}")
    items, length, depth = q.shape
    q, k = q.contiguous(), k.contiguous()
    out = torch.empty((items, length, length), dtype=torch.bfloat16, device=q.device)
    if items and length:
        with torch.cuda.device(q.device):
            code = _build.library().sst_wide_attention_scores(
                q.data_ptr(), k.data_ptr(), out.data_ptr(), items, length, depth,
                depth ** -0.5, torch.cuda.current_stream().cuda_stream,
            )
        _build.check(code, "wide_attention_scores")
        wide_attention_scores.launches += 1
    return out


wide_attention_scores.launches = 0


def wide_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q, k [N, L, d]``, ``v [N, L, dv]`` → ``[N, L, dv]``: on a GPU the
    kernel's bf16 probabilities times ``v`` (bf16) in ``torch.matmul``; else
    the plain version."""
    if use_plain(q):
        return wide_attention_plain(q, k, v)
    if v.dtype != torch.bfloat16:
        raise TypeError(f"wide_attention: the kernel's path takes bf16 v, got {v.dtype}")
    if v.dim() != 3 or v.shape[:2] != q.shape[:2]:
        raise ValueError(f"wide_attention: v [N, L, dv] beside q {tuple(q.shape)}, got "
                         f"{tuple(v.shape)}")
    return torch.matmul(wide_attention_scores(q, k), v)
