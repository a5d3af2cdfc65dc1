"""Multi-head self-attention's core, softmax(q kᵀ / √d) v, over ``[N, heads,
L, d]``, with no mask.

On a CUDA tensor it runs ``F.scaled_dot_product_attention`` pinned to its
flash backend (``torch.nn.attention.sdpa_kernel``): an input that the flash
kernel cannot take (fp32, a head size it lacks) raises, and nothing falls
back to SDPA's math backend. A CPU tensor, or a call inside
``ops.plain_versions()``, runs :func:`attention_plain` (``ops/dispatch.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .dispatch import use_plain

__all__ = ["attention", "attention_plain"]

FLASH_DTYPES = (torch.bfloat16, torch.float16)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The scores, their softmax and the product with ``v`` written out, in
    fp32 whatever the inputs' dtype; the result in ``q``'s dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``q, k, v [N, heads, L, d]`` → ``[N, heads, L, d]`` in their dtype:
    SDPA's flash kernel on a GPU (bf16 or fp16 only), else the plain version."""
    if use_plain(q):
        return attention_plain(q, k, v)
    if q.dtype not in FLASH_DTYPES:
        raise ValueError(
            f"attention: SDPA's flash kernel takes bf16 or fp16, not {q.dtype} (serve in bf16, "
            "or run the plain version inside ops.plain_versions())"
        )
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v)
