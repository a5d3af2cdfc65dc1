"""Nearest-codebook search kernel (counterpart of ``ops/vq_pallas.py``).

:func:`nearest_code` runs ``csrc/nearest_code.cu``: for each row of ``flat
[N, D]`` the index of the nearest column of ``codebook [D, K]``, the argmin
over K of ``‖e‖² − 2·x·e`` in fp32 FMA (no TF32), with no ``[N, K]`` matrix
in device memory; exact ties go to the lowest index. Its plain version,
:func:`nearest_code_plain`, computes the same formula with one matmul and
``torch.argmin``; the wrapper takes it only for tensors on the CPU, and on a
CUDA tensor launches the kernel or raises. Both return int32 indices, the
dtype of the JAX function.

The search drops ``‖x‖²``, constant per row, as the Pallas kernel does; the
JAX package's XLA branch keeps it, which can only matter at near ties.
"""

from __future__ import annotations

import torch

from .. import _build

__all__ = ["MAX_DIM", "nearest_code", "nearest_code_plain"]

MAX_DIM = 256  # the kernel stages (64 + 128) x D floats in shared memory


def nearest_code_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``argmin_k (‖e_k‖² − 2·flat_n·e_k)`` as int32 ``[N]``: the kernel's formula."""
    scores = (codebook * codebook).sum(0) - 2.0 * (flat @ codebook)
    return torch.argmin(scores, dim=1).to(torch.int32)


def nearest_code(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook column for each row: ``flat [N, D]`` and
    ``codebook [D, K]`` fp32 → int32 ``[N]``."""
    if flat.device.type == "cpu" and codebook.device.type == "cpu":
        return nearest_code_plain(flat, codebook)
    if flat.device.type != "cuda" or codebook.device != flat.device:
        raise ValueError(f"nearest_code: unsupported devices {flat.device}, {codebook.device}")
    if flat.dim() != 2 or codebook.dim() != 2 or codebook.shape[0] != flat.shape[1]:
        raise ValueError(f"nearest_code: expected flat [N, D] and codebook [D, K], got "
                         f"{tuple(flat.shape)} and {tuple(codebook.shape)}")
    if flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_code: expected float32, got {flat.dtype} and {codebook.dtype}")
    if not (flat.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("nearest_code: flat and codebook must be contiguous")
    rows, dim = flat.shape
    codes = codebook.shape[1]
    if not 1 <= dim <= MAX_DIM or codes < 1:
        raise ValueError(f"nearest_code: needs 1 <= D <= {MAX_DIM} and K >= 1, got D={dim}, "
                         f"K={codes}")
    out = torch.empty(rows, dtype=torch.int32, device=flat.device)
    if rows == 0:
        return out
    with torch.cuda.device(flat.device):
        code = _build.library().sst_nearest_code(
            flat.data_ptr(), codebook.data_ptr(), out.data_ptr(), rows, dim, codes,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "nearest_code")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
