"""Conv-TasNet TCN trunk for training (counterpart of ``ops/tcn_train_pallas.py``).

:func:`tcn_trunk_train` is the differentiable trunk over the canonical arrays
of :func:`~.tcn_cuda.stack_canonical` (``we [N, cb, ch]``, ``wdw [N, taps,
ch]``, ``wcat [N, ch, 2cb]``, ``vecs [N, 10, vdim]``), a
:class:`torch.autograd.Function` whose two passes are CUDA kernels:

- :func:`tcn_train_forward` — the serving trunk (``csrc/tcn_trunk.cu``, its
  training mode), bit for bit, storing each block's input ``h`` and its four
  gLN statistics as residuals;
- :func:`tcn_train_backward` — the blocks in reverse, recomputing the
  hidden-width tensors from the residuals: ``csrc/tcn_train_backward.cu``.

Each has a plain PyTorch version with the same roundings, which the wrapper
takes only for a tensor on the CPU; on a CUDA tensor it launches the kernel or
raises. The plain versions also take a ``storage`` dtype (bf16, the kernels'
contract; fp32 separates the derivation from bf16 noise). Gradients reach
every canonical array and, through ``stack_canonical``, the ``ConvTasNet``
parameters: the PReLU slopes
(rows 8 and 9) get one gradient per lane, which the lane broadcast of
``stack_canonical`` sums back to the scalar.

The forward folds gLN2's gamma into the res|skip product as the serving
kernel does (``fold_canonical``); the TPU training forward folds ``g2 / sigma2``
per item before its bf16 cast. Both compute the same function with roundings
at other places, so the port is held to the JAX trunk by a stated SNR, not
bit for bit. The backward is the TPU kernel's arithmetic (its phases P1 to P6,
see ``csrc/tcn_train_backward.cu``) with its roundings.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .tcn_cuda import fold_canonical, launch_trunk, trunk_forward_plain

__all__ = [
    "tcn_trunk_train",
    "tcn_train_forward",
    "tcn_train_forward_plain",
    "tcn_train_backward",
    "tcn_train_backward_plain",
]

_MAX_TAPS = 8  # csrc/tcn_train_backward.cu's per-thread tap accumulators
_SPLIT = 1024  # frames per chunk of the backward's weight-gradient products
# csrc/tcn_common.cuh's WMMA tile (kBM, kBN), which sizes the backward's per-tile scratch
_TILE_ROWS = 64
_TILE_COLS = 128


def tcn_train_forward_plain(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3,
                            storage: torch.dtype = torch.bfloat16):
    """Plain version of :func:`tcn_train_forward`, on any device."""
    return trunk_forward_plain(h0, we, wdw, wg, vecs, dils=dils, taps=taps, storage=storage,
                               residuals=True)


def tcn_train_forward(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3):
    """The trunk's training forward over the folded arrays of
    :func:`~.tcn_cuda.fold_canonical`: ``(skip [B, K, cb], hb [N, B, K, cb])``
    in bf16 and ``st [N, B, 4]`` fp32, ``(mu1, 1/sigma1, mu2,
    1/sigma2)`` per block and item. ``skip`` is :func:`~.tcn_cuda.tcn_trunk_cuda`'s
    output bit for bit; ``hb[j]`` is block ``j``'s input."""
    if h0.device.type == "cpu":
        return tcn_train_forward_plain(h0, we, wdw, wg, vecs, dils=dils, taps=taps)
    out = launch_trunk(h0, we, wdw, wg, vecs, dils=dils, taps=taps, name="tcn_train_forward",
                       residuals=True)
    tcn_train_forward.launches += 1
    return out


tcn_train_forward.launches = 0


def _check_backward(dskip, hb, st, we, wdw, wcat, vecs, dils, taps):
    n, b, k, cb = hb.shape
    ch = we.shape[2]
    want = {
        "dskip": (tuple(dskip.shape), (b, k, cb)),
        "st": (tuple(st.shape), (n, b, 4)),
        "we": (tuple(we.shape), (n, cb, ch)),
        "wdw": (tuple(wdw.shape), (n, taps, ch)),
        "wcat": (tuple(wcat.shape), (n, ch, 2 * cb)),
    }
    for name, (got, expected) in want.items():
        if got != expected:
            raise ValueError(f"tcn_train_backward: {name} {got}, expected {expected}")
    if vecs.shape[0] != n or vecs.shape[1] != 10 or vecs.shape[2] < max(ch, 2 * cb):
        raise ValueError(f"tcn_train_backward: vecs {tuple(vecs.shape)}, expected [{n}, 10, >= "
                         f"{max(ch, 2 * cb)}]")
    if len(dils) != n or min(dils) < 1:
        raise ValueError(f"tcn_train_backward: dilations {tuple(dils)} for {n} blocks")
    return b, k, cb, ch, n


def tcn_train_backward_plain(dskip, hb, st, we, wdw, wcat, vecs, *, dils: Sequence[int],
                             taps: int = 3, storage: torch.dtype = torch.bfloat16):
    """Plain version of :func:`tcn_train_backward`, on any device: the TPU
    backward's arithmetic, rounding to ``storage`` where it stores a slab."""
    b, k, cb, ch, n = _check_backward(dskip, hb, st, we, wdw, wcat, vecs, dils, taps)
    dev = dskip.device
    inv_n = torch.tensor(1.0 / (k * ch), dtype=torch.float32, device=dev)
    rows = torch.arange(k, device=dev)

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(storage).float()

    def shift(x: torch.Tensor, off: int) -> torch.Tensor:
        """``x[:, u + off]`` along frames, zero outside ``[0, K)``."""
        if off >= 0:
            return F.pad(x[:, off:], (0, 0, 0, min(off, k)))
        return F.pad(x[:, : k + off], (0, 0, min(-off, k), 0))

    vdim = vecs.shape[2]
    dh = torch.zeros((b, k, cb), dtype=torch.float32, device=dev)
    ds = dskip.float()
    dwe = torch.empty((n, cb, ch), dtype=torch.float32, device=dev)
    dwdw = torch.empty((n, taps, ch), dtype=torch.float32, device=dev)
    dwcat = torch.empty((n, ch, 2 * cb), dtype=torch.float32, device=dev)
    dvec = torch.zeros((n, 10, vdim), dtype=torch.float32, device=dev)
    for j in reversed(range(n)):
        d_j = int(dils[j])
        h = hb[j].float()
        we_j, wcat_j = rnd(we[j]), rnd(wcat[j])
        v = vecs[j].float()
        be, g1, b1, bdw = v[0, :ch], v[1, :ch], v[2, :ch], v[3, :ch]
        g2, b2, a1, a2 = v[4, :ch], v[5, :ch], v[8, :ch], v[9, :ch]
        w = [wdw[j, t].float() for t in range(taps)]
        mu1, s1, mu2, s2 = (st[j, :, i, None, None] for i in range(4))
        av1 = g1 * s1  # [B, 1, ch]
        bv1 = b1 - mu1 * av1
        pad = (taps - 1) * d_j // 2
        rels = [t * d_j - pad for t in range(taps)]

        # P1, P2: recompute t1 and the pre-PReLU depthwise output d
        y = h @ we_j + be
        t1 = rnd(torch.where(y >= 0, y, a1 * y))
        wsum = w[0]
        for t in range(1, taps):
            wsum = wsum + w[t]
        pre = bv1 * wsum + bdw
        for t, rel in enumerate(rels):
            pre = pre + (av1 * w[t]) * shift(t1, rel)
        for t, rel in enumerate(rels):
            if rel:
                invalid = ((rows + rel < 0) | (rows + rel >= k)).float()[None, :, None]
                pre = pre - (bv1 * w[t]) * invalid
        d = rnd(pre)

        # P3: res|skip backward, gLN2 sums
        xh2 = (torch.where(d >= 0, d, a2 * d) - mu2) * s2
        n2 = rnd(g2 * xh2 + b2)
        drs = rnd(torch.cat([dh, ds], dim=-1))
        dn2 = drs @ wcat_j.T
        dwcat[j] = torch.einsum("bkc,bko->co", n2, drs)
        dvec[j, 6, : 2 * cb] = drs.sum(dim=(0, 1))
        dvec[j, 4, :ch] = (dn2 * xh2).sum(dim=(0, 1))
        dvec[j, 5, :ch] = dn2.sum(dim=(0, 1))
        dxh2 = dn2 * g2
        ma2 = (dxh2.sum(dim=(1, 2)) * inv_n)[:, None, None]
        mb2 = ((dxh2 * xh2).sum(dim=(1, 2)) * inv_n)[:, None, None]

        # P4: gLN2 and PReLU2 backward
        dt2 = s2 * (rnd(dxh2) - ma2 - xh2 * mb2)
        ddc = torch.where(d >= 0, dt2, a2 * dt2)
        dvec[j, 9, :ch] = (dt2 * torch.clamp(d, max=0.0)).sum(dim=(0, 1))
        dvec[j, 3, :ch] = ddc.sum(dim=(0, 1))
        dd = rnd(ddc)

        # P5: the dilated taps transposed, dw, gLN1 sums
        dn1 = torch.zeros_like(dd)
        for t, rel in enumerate(rels):
            dn1 = dn1 + w[t] * shift(dd, -rel)
            n1 = shift(av1 * t1 + bv1, rel)  # the normalised input, zero-padded
            dwdw[j, t] = (dd * n1).sum(dim=(0, 1))
        xh1 = (t1 - mu1) * s1
        dvec[j, 1, :ch] = (dn1 * xh1).sum(dim=(0, 1))
        dvec[j, 2, :ch] = dn1.sum(dim=(0, 1))
        dxh1 = dn1 * g1
        ma1 = (dxh1.sum(dim=(1, 2)) * inv_n)[:, None, None]
        mb1 = ((dxh1 * xh1).sum(dim=(1, 2)) * inv_n)[:, None, None]

        # P6: gLN1 and PReLU1 backward, the expand product's gradients
        dt1 = s1 * (rnd(dxh1) - ma1 - xh1 * mb1)
        dt1p = torch.where(y >= 0, dt1, a1 * dt1)
        dvec[j, 8, :ch] = (dt1 * torch.clamp(y, max=0.0)).sum(dim=(0, 1))
        dvec[j, 0, :ch] = dt1p.sum(dim=(0, 1))
        dt1p = rnd(dt1p)
        dwe[j] = torch.einsum("bkc,bko->co", h, dt1p)
        dh = dh + dt1p @ we_j.T
    return dh, dwe, dwdw, dwcat, dvec


def tcn_train_backward(dskip, hb, st, we, wdw, wcat, vecs, *, dils: Sequence[int],
                       taps: int = 3):
    """The trunk's backward: ``(dh0 [B, K, cb], dwe, dwdw, dwcat, dvec)``, all
    fp32, the gradients of ``h0`` and of the canonical arrays given the skip
    sum's gradient ``dskip [B, K, cb]`` and :func:`tcn_train_forward`'s
    residuals ``hb``, ``st``. ``we``, ``wcat`` are used in bf16."""
    if dskip.device.type == "cpu":
        return tcn_train_backward_plain(dskip, hb, st, we, wdw, wcat, vecs, dils=dils, taps=taps)
    tensors = (dskip, hb, st, we, wdw, wcat, vecs)
    if dskip.device.type != "cuda" or any(t.device != dskip.device for t in tensors):
        raise ValueError(f"tcn_train_backward: tensors on {[str(t.device) for t in tensors]}")
    b, k, cb, ch, n = _check_backward(dskip, hb, st, we, wdw, wcat, vecs, dils, taps)
    if cb % 8 or ch % 8:
        raise ValueError(f"tcn_train_backward: cb={cb} and ch={ch} must be multiples of 8")
    if taps > _MAX_TAPS:
        raise ValueError(f"tcn_train_backward: {taps} taps, at most {_MAX_TAPS}")
    if hb.dtype != torch.bfloat16:
        raise TypeError(f"tcn_train_backward: hb must be bf16, got {hb.dtype}")
    dev = dskip.device
    vdim = vecs.shape[2]
    hb, st = hb.contiguous(), st.float().contiguous()
    dskip = dskip.float().contiguous()
    we, wcat = we.to(torch.bfloat16).contiguous(), wcat.to(torch.bfloat16).contiguous()
    wdw, vecs = wdw.float().contiguous(), vecs.float().contiguous()
    dh = torch.empty((b, k, cb), dtype=torch.float32, device=dev)
    dwe = torch.empty((n, cb, ch), dtype=torch.float32, device=dev)
    dwdw = torch.empty((n, taps, ch), dtype=torch.float32, device=dev)
    dwcat = torch.empty((n, ch, 2 * cb), dtype=torch.float32, device=dev)
    dvec = torch.empty((n, 10, vdim), dtype=torch.float32, device=dev)
    frames = b * k
    tiles = math.ceil(k / _TILE_ROWS)
    parts = b * tiles
    scratch16 = torch.empty(frames * (2 * cb + 5 * ch), dtype=torch.bfloat16, device=dev)
    scratch32 = torch.empty(
        2 * parts * math.ceil(ch / _TILE_COLS) + 2 * parts + parts * 10 * vdim + parts * taps * ch
        + math.ceil(frames / _SPLIT) * max(ch * 2 * cb, cb * ch),
        dtype=torch.float32, device=dev,
    )
    dil_array = (ctypes.c_int * n)(*(int(d) for d in dils))
    with torch.cuda.device(dev):
        code = _build.library().sst_tcn_trunk_backward(
            hb.data_ptr(), st.data_ptr(), dskip.data_ptr(), dh.data_ptr(), we.data_ptr(),
            wdw.data_ptr(), wcat.data_ptr(), vecs.data_ptr(), ctypes.addressof(dil_array),
            dwe.data_ptr(), dwdw.data_ptr(), dwcat.data_ptr(), dvec.data_ptr(),
            scratch16.data_ptr(), scratch32.data_ptr(), b, k, cb, ch, vdim, taps, n,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "tcn_train_backward")
    tcn_train_backward.launches += 1
    return dh, dwe, dwdw, dwcat, dvec


tcn_train_backward.launches = 0


class _TrunkTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, we, wdw, wcat, vecs, dils, taps, plain, storage):
        folded = fold_canonical(we, wdw, wcat, vecs, storage)
        if plain:
            skip, hb, st = tcn_train_forward_plain(h0, *folded, dils=dils, taps=taps,
                                                   storage=storage)
        else:
            skip, hb, st = tcn_train_forward(h0, *folded, dils=dils, taps=taps)
        ctx.save_for_backward(hb, st, we, wdw, wcat, vecs)
        ctx.config = (dils, taps, plain, storage, h0.dtype)
        return skip

    @staticmethod
    def backward(ctx, dskip):
        hb, st, we, wdw, wcat, vecs = ctx.saved_tensors
        dils, taps, plain, storage, h0_dtype = ctx.config
        args = (dskip, hb, st, we, wdw, wcat, vecs)
        if plain:
            grads = tcn_train_backward_plain(*args, dils=dils, taps=taps, storage=storage)
        else:
            grads = tcn_train_backward(*args, dils=dils, taps=taps)
        dh0, dwe, dwdw, dwcat, dvec = grads
        return (dh0.to(h0_dtype), dwe.to(we.dtype), dwdw.to(wdw.dtype), dwcat.to(wcat.dtype),
                dvec.to(vecs.dtype), None, None, None, None)


def tcn_trunk_train(h0, we, wdw, wcat, vecs, *, dils: Sequence[int], taps: int = 3,
                    plain: bool = False, storage: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Differentiable trunk: the skip sum ``[B, K, cb]`` in ``storage``.

    ``h0 [B, K, cb]``; the canonical arrays of ``stack_canonical`` (fp32
    masters, cast inside); ``dils`` one dilation per block, at most 64.
    Gradients flow to ``h0`` and to every canonical array. ``plain=True``
    runs both passes' plain versions on any device; ``storage=torch.float32``
    (plain only) rounds nothing.
    """
    if storage != torch.bfloat16 and not plain:
        raise ValueError(f"tcn_trunk_train: the kernels store bf16; storage {storage} needs "
                         "plain=True")
    return _TrunkTrain.apply(h0, we, wdw, wcat, vecs, tuple(int(d) for d in dils), taps, plain,
                             storage)
