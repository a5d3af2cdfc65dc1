"""Conv-TasNet's mask head and decoder in one pass (``csrc/mask_decode.cu``).

:func:`mask_decode` takes the mask projection's product ``logits [B, K,
S·N]`` (its bias not yet added), the bias ``mask_b [S·N]``, the encoder's
features ``feats [B, K, N]`` (on the kernel's path the transpose of a
contiguous ``[B, N, K]``, as ``models/tasnet.py::encode`` returns them), the
decoder's kernel ``dec_k [win, N, 1]`` and bias ``dec_b [1]``, and returns
the separated waveforms, fp32 ``[B, S, samples]``:

- ``v = sigmoid(logits + mask_b) · feats``, in fp32, rounded once to
  ``feats``' dtype (bf16 on the kernel's path);
- each frame's ``win`` taps ``v @ dec_k`` (fp32 sums of exact products);
- each sample the sum of the taps of the frames that cover it, plus the
  bias: flax's "SAME" ``ConvTranspose`` at stride ``win // 2``
  (``models/tasnet.py::decode``), whose frame ``t`` writes tap ``j`` to
  sample ``t · stride + left − j``, ``left`` from ``conv_transpose_pads``;
- the first ``samples`` samples (at most ``K · stride``).

``models/tasnet_serving.py::cuda_apply`` ends in it; ``fused_apply`` and
``train_apply`` keep the chain of PyTorch operations (``_mask_and_decode``),
which rounds the mask's bias add, its sigmoid and the decoder's output to
bf16 besides. The kernel has no JAX counterpart.

:func:`mask_decode_plain` is the same function in PyTorch, run where
``dispatch.use_plain`` says (a CPU tensor, or inside ``plain_versions()``);
any other tensor launches the kernel or raises. The kernel is forward only:
it raises where autograd would record.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .dispatch import use_plain

__all__ = ["MAX_CHANNELS", "MAX_WIN", "mask_decode", "mask_decode_plain"]

MAX_CHANNELS = 512  # the kernel's kMaxChannels: N, a multiple of 8
MAX_WIN = 64  # the kernel's kMaxWin


def _shape(logits: torch.Tensor, feats: torch.Tensor, dec_k: torch.Tensor, samples: int):
    """``(speakers, win, stride, left)``, or ``ValueError`` where the shapes disagree."""
    if logits.dim() != 3 or feats.dim() != 3 or logits.shape[:2] != feats.shape[:2]:
        raise ValueError(f"mask_decode: logits [B, K, S·N] and feats [B, K, N] expected, got "
                         f"{tuple(logits.shape)}, {tuple(feats.shape)}")
    n = feats.shape[2]
    if n == 0 or logits.shape[2] % n:
        raise ValueError(f"mask_decode: logits' {logits.shape[2]} columns are no multiple of "
                         f"feats' {n} channels")
    if dec_k.dim() != 3 or dec_k.shape[1:] != (n, 1) or dec_k.shape[0] < 2:
        raise ValueError(f"mask_decode: dec_k [win >= 2, {n}, 1] expected, got "
                         f"{tuple(dec_k.shape)}")
    win = dec_k.shape[0]
    stride = win // 2
    if not 1 <= samples <= logits.shape[1] * stride:
        raise ValueError(f"mask_decode: 1 to K · stride = {logits.shape[1] * stride} samples, "
                         f"got {samples}")
    # models/tasnet.py::conv_transpose_pads(win, stride)[0]: half of win + stride − 2,
    # rounded up (stride < win, so never its stride > win − 1 case)
    return logits.shape[2] // n, win, stride, (win + stride - 1) // 2


def mask_decode_plain(logits: torch.Tensor, mask_b: torch.Tensor, feats: torch.Tensor,
                      dec_k: torch.Tensor, dec_b: torch.Tensor, samples: int) -> torch.Tensor:
    """The kernel's function in PyTorch, fp32 ``[B, S, samples]``; ``v`` is
    rounded to ``feats``' dtype."""
    speakers, win, stride, left = _shape(logits, feats, dec_k, samples)
    b, k, n = feats.shape
    masks = torch.sigmoid(logits.float() + mask_b.float()).view(b, k, speakers, n)
    v = (masks * feats.float()[:, :, None, :]).to(feats.dtype)
    taps = v.float() @ dec_k[:, :, 0].float().T  # [B, K, S, win]
    # frame t's taps reversed land at t · stride + r of a frame-aligned buffer,
    # which starts win − 1 − left samples before sample 0
    cols = taps.flip(-1).permute(0, 2, 3, 1).reshape(b * speakers, win, k)
    length = (k - 1) * stride + win
    full = F.fold(cols, (1, length), (1, win), stride=(1, stride)).view(b, speakers, length)
    start = win - 1 - left
    full = F.pad(full, (0, max(start + samples - length, 0)))
    return full[..., start:start + samples] + dec_b.float()


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def mask_decode(logits: torch.Tensor, mask_b: torch.Tensor, feats: torch.Tensor,
                dec_k: torch.Tensor, dec_b: torch.Tensor, samples: int) -> torch.Tensor:
    """The separated waveforms, fp32 ``[B, S, samples]``: the mask head from
    its product on and the transposed decoder, in one kernel launch on a
    CUDA tensor."""
    if use_plain(logits):
        return mask_decode_plain(logits, mask_b, feats, dec_k, dec_b, samples)
    operands = (logits, mask_b, feats, dec_k, dec_b)
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError(f"mask_decode: bf16 operands only, got "
                        f"{', '.join(str(t.dtype) for t in operands)}")
    speakers, win, stride, left = _shape(logits, feats, dec_k, samples)
    b, k, n = feats.shape
    if mask_b.shape != (speakers * n,) or dec_b.shape != (1,):
        raise ValueError(f"mask_decode: mask_b [{speakers * n}] and dec_b [1] expected, got "
                         f"{tuple(mask_b.shape)}, {tuple(dec_b.shape)}")
    if n % 8 or n > MAX_CHANNELS or win > MAX_WIN:
        raise ValueError(f"mask_decode: N a multiple of 8 up to {MAX_CHANNELS} and win up to "
                         f"{MAX_WIN}, got N = {n}, win = {win}")
    if b > 65535 or speakers > 65535 or logits.numel() >= 2**31 or k * stride >= 2**31:
        raise ValueError(f"mask_decode: too large for the kernel's grid and 32-bit indices: "
                         f"{tuple(logits.shape)}")
    if not (logits.is_contiguous() and mask_b.is_contiguous() and dec_k.is_contiguous()
            and feats.transpose(1, 2).is_contiguous()):
        raise ValueError("mask_decode: logits, mask_b and dec_k must be contiguous, and feats "
                         "[B, K, N] the transpose of a contiguous [B, N, K] (the encoder's)")
    if any(t.data_ptr() % 16 for t in (logits, mask_b, dec_k)):
        raise ValueError("mask_decode: logits, mask_b and dec_k must start 16-byte aligned")
    if logits.device.type != "cuda" or any(t.device != logits.device for t in operands):
        raise ValueError(f"mask_decode: every operand on one CUDA device, got logits on "
                         f"{logits.device}")
    if _records(*operands):
        raise RuntimeError("mask_decode: the kernel is forward only; call it where autograd "
                           "does not record")
    out = torch.empty(b, speakers, samples, dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        code = _build.library().sst_mask_decode(
            logits.data_ptr(), mask_b.data_ptr(), feats.data_ptr(), dec_k.data_ptr(),
            dec_b.data_ptr(), out.data_ptr(), b, k, speakers, n, win, stride, left, samples,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "mask_decode")
    mask_decode.launches += 1
    return out


mask_decode.launches = 0
