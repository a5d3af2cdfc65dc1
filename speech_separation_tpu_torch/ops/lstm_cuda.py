"""LSTM recurrence kernel (counterpart of ``ops/lstm_pallas.py``).

:func:`lstm_recurrence` runs the recurrence of one or both directions of an
(Bi)LSTM layer over precomputed input projections ``xw = x @ W + b``, in
``csrc/lstm_recurrence.cu``. :func:`lstm_recurrence_plain` is its plain
PyTorch version (a Python loop over time), which the wrapper takes only for a
tensor on the CPU; on a CUDA tensor it launches the kernel or raises.

Semantics follow ``lstm_pallas``: Keras gate order i, f, g, o; the (h, c)
carry in fp32; operands (xw, U and h before each product) in the compute
dtype, fp32 or bf16, with fp32 accumulation; outputs in the compute dtype. A
reversed direction walks time backwards over the full padded length and
writes each output at its own time index, which equals the JAX BiLSTM's
flip, scan, flip back.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import _build

__all__ = ["lstm_recurrence", "lstm_recurrence_plain"]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(xw: torch.Tensor, recurrent: torch.Tensor, reverse: Sequence[bool]):
    if xw.dim() != 4 or recurrent.dim() != 3:
        raise ValueError(
            f"expected xw [D, B, T, 4H] and recurrent [D, H, 4H], got "
            f"{tuple(xw.shape)} and {tuple(recurrent.shape)}"
        )
    dirs, _, _, four_h = xw.shape
    hidden = four_h // 4
    if four_h != 4 * hidden or tuple(recurrent.shape) != (dirs, hidden, four_h):
        raise ValueError(
            f"recurrent {tuple(recurrent.shape)} does not match xw {tuple(xw.shape)}"
        )
    if len(reverse) != dirs or dirs not in (1, 2):
        raise ValueError(f"need one reverse flag per direction (1 or 2), got {reverse!r}")
    return hidden


def lstm_recurrence_plain(
    xw: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    reverse: Sequence[bool],
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of :func:`lstm_recurrence`, on any device."""
    hidden = _check_shapes(xw, recurrent, reverse)
    dtype = compute_dtype or xw.dtype
    # bf16 operands are exact in fp32, so fp32 products accumulate as the kernel's
    xw32 = xw.to(dtype).to(torch.float32)
    u32 = recurrent.to(dtype).to(torch.float32)
    dirs, batch, steps, _ = xw.shape
    h = xw32.new_zeros((dirs, batch, hidden))
    c = xw32.new_zeros((dirs, batch, hidden))
    out = torch.empty((batch, steps, dirs * hidden), dtype=dtype, device=xw.device)
    for s in range(steps):
        times = [steps - 1 - s if r else s for r in reverse]
        x_t = torch.stack([xw32[d, :, t] for d, t in enumerate(times)])
        z = x_t + torch.bmm(h.to(dtype).to(torch.float32), u32)
        i, f, g, o = z.split(hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        for d, t in enumerate(times):
            out[:, t, d * hidden : (d + 1) * hidden] = h[d].to(dtype)
    return out


def lstm_recurrence(
    xw: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    reverse: Sequence[bool],
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Every hidden state ``[B, T, D * H]`` of ``D`` directions.

    ``xw``: ``[D, B, T, 4H]``, ``recurrent``: ``[D, H, 4H]``, ``reverse``: one
    flag per direction (a BiLSTM passes ``(False, True)``). ``compute_dtype``
    defaults to ``xw.dtype``.
    """
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, recurrent, reverse=reverse, compute_dtype=compute_dtype)
    if xw.device.type != "cuda" or recurrent.device != xw.device:
        raise ValueError(f"lstm_recurrence: tensors on {xw.device} and {recurrent.device}")
    hidden = _check_shapes(xw, recurrent, reverse)
    dtype = compute_dtype or xw.dtype
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"lstm_recurrence: compute dtype {dtype} not in {_KERNEL_DTYPES}")
    xw = xw.to(dtype).contiguous()
    recurrent = recurrent.to(dtype).contiguous()
    dirs, batch, steps, _ = xw.shape
    h = torch.zeros((2, dirs, batch, hidden), dtype=torch.float32, device=xw.device)
    c = torch.zeros((dirs, batch, hidden), dtype=torch.float32, device=xw.device)
    out = torch.empty((batch, steps, dirs * hidden), dtype=dtype, device=xw.device)
    reverse_mask = sum(1 << d for d, r in enumerate(reverse) if r)
    with torch.cuda.device(xw.device):
        code = _build.library().sst_lstm_recurrence(
            xw.data_ptr(), recurrent.data_ptr(), h[0].data_ptr(), h[1].data_ptr(),
            c.data_ptr(), out.data_ptr(), dirs, batch, steps, hidden, reverse_mask,
            int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "lstm_recurrence")
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
