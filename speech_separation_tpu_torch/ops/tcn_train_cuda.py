"""Conv-TasNet TCN trunk for training (counterpart of ``ops/tcn_train_pallas.py``).

:func:`tcn_trunk_train` is the differentiable trunk over the canonical arrays
of :func:`~.tcn_cuda.stack_canonical` (``we [N, cb, ch]``, ``wdw [N, taps,
ch]``, ``wcat [N, ch, 2cb]``, ``vecs [N, 10, vdim]``), a
:class:`torch.autograd.Function` whose two passes are CUDA kernels:

- :func:`tcn_train_forward` — the serving trunk (``csrc/tcn_trunk.cu``, its
  training mode), bit for bit, storing each block's input ``h`` and its four
  gLN statistics as residuals;
- :func:`tcn_train_backward` — the blocks in reverse, recomputing the
  hidden-width tensors from the residuals: ``csrc/tcn_train_backward.cu``,
  one cooperative launch a call laid out by :func:`backward_plan`.

Each has a plain PyTorch version with the same roundings, which the wrapper
takes where ``dispatch.use_plain`` says (a CPU tensor, or inside
``plain_versions()``); otherwise it launches the kernel or raises. The plain
versions also take a ``storage`` dtype (bf16, the kernels' contract; fp32,
inside ``plain_versions()`` on a GPU, separates the derivation from bf16
noise). Gradients reach
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
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .dispatch import use_plain
from .tcn_cuda import (
    MAX_DILATION,
    TRUNK_DEPTH,
    TRUNK_MAX_BLOCKS,
    TRUNK_MAX_TAPS,
    TRUNK_SLICE,
    TRUNK_STAGES,
    TRUNK_TILE_ROWS,
    TRUNK_L2_SHARE,
    _RESERVED_BYTES,
    _device_limits,
    fold_canonical,
    launch_trunk,
    trunk_forward_plain,
)

__all__ = [
    "tcn_trunk_train",
    "tcn_train_forward",
    "tcn_train_forward_plain",
    "tcn_train_backward",
    "tcn_train_backward_plain",
    "BackwardPlan",
    "backward_plan",
    "backward_smem_bytes",
    "TRUNK_BWD_LAPS",
    "BWD_TILE_COLS",
    "trunk_backward_phase_ms",
    "launch_backward",
]

# csrc/tcn_train_backward.cu's constants (tests hold them to the source)
BWD_TILE_COLS = 128  # output columns a product pass: wgmma m64n128k16
BWD_VEC_ROWS = 10  # rows of vecs (stack_canonical); the partials add one a tap
BWD_COLRED = (2 + TRUNK_MAX_TAPS) * TRUNK_SLICE * 8  # floats of the column-sum exchange
# the parts of a block csrc/tcn_train_backward.cu times with %globaltimer (its enum Lap)
TRUNK_BWD_LAPS = ("coefficients", "P1 t1", "P2 d", "P3 drs", "P3 products", "P3 epilogue",
                  "P3 dWcat", "P4 dd", "P5 taps", "P6 products", "P6 epilogue", "P6 dWe",
                  "P6 dh", "waiting", "final sums")


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """One cooperative launch of ``groups`` x ``ctas`` CTAs, one an SM: item
    ``i`` belongs to group ``i % groups``, whose CTAs walk its blocks in
    reverse, CTA ``rank`` owning the 128-row tiles ``rank, rank + ctas, ...``
    in every phase. Each CTA keeps an fp32 partial of every block's weight
    gradients and column sums, summed over its tiles and items and then over
    the CTAs once at the end."""

    groups: int
    ctas: int
    tiles: int  # 128-row tiles an item
    smem: int  # dynamic shared memory a CTA
    item_bytes: int  # one item in flight that other tiles or blocks read: t1, dd, dh, dskip
    slab_bytes: int  # one item's slabs that only their owner reads back: d, n2, dxh, drs
    weight_bytes: int  # every block's weights
    l2_budget: int
    halo: int  # rows P2 and P5 stage beyond a tile: (taps - 1) x the largest dilation
    weight_tiles: int  # 128 x 128 tiles of a block's dWcat and dWe
    partial_bytes: int  # the CTAs' partials: weight-gradient tiles and column sums

    @property
    def grid(self) -> int:
        return self.groups * self.ctas

    @property
    def resident(self) -> bool:
        """Whether the items in flight and the weights fit the L2 budget."""
        return self.groups * self.item_bytes + self.weight_bytes <= self.l2_budget


def backward_smem_bytes(taps: int, max_dil: int, cb: int, ch: int) -> int:
    """Dynamic shared memory of ``csrc/tcn_train_backward.cu``: a staging area,
    the product's ring (128 output columns a pass), P4's two pairs of input
    slots, or P5's two pairs of buffers (dd and t1, a tile's rows
    and halo for a 64-channel slice), whichever is larger, aligned to 1,024
    bytes; then, in fp32, a block's vectors and depthwise weights (``(8 +
    taps) ch``), the column-sum exchange (``BWD_COLRED``), the block's
    column sums (``(10 + taps) max(ch, 2 cb)``) and the item's sums of
    bf16(dskip) (``cb``)."""
    span = TRUNK_TILE_ROWS + (taps - 1) * max_dil
    buf = -(-(span * TRUNK_SLICE * 2) // 1024) * 1024
    ring = TRUNK_STAGES * (TRUNK_TILE_ROWS + BWD_TILE_COLS) * TRUNK_DEPTH * 2
    vdim = max(ch, 2 * cb)
    slots = 4 * TRUNK_TILE_ROWS * BWD_TILE_COLS * 2  # P4's two pairs of input slots
    return 1024 + max(ring, slots, 4 * buf) + 4 * ((8 + taps) * ch + BWD_COLRED
                                            + (BWD_VEC_ROWS + taps) * vdim + cb)


def _weight_tiles(cb: int, ch: int) -> int:
    rows, cols = TRUNK_TILE_ROWS, BWD_TILE_COLS
    return -(-ch // rows) * -(-2 * cb // cols) + -(-cb // rows) * -(-ch // cols)


def backward_plan(batch: int, frames: int, cb: int, ch: int, taps: int, dils: Sequence[int], *,
                  sms: int, smem_optin: int, smem_per_sm: int, l2_bytes: int) -> BackwardPlan:
    """The backward's launch plan on a card with ``sms`` SMs, ``smem_optin``
    bytes of shared memory a block, ``smem_per_sm`` an SM and ``l2_bytes`` of
    L2. Of the group counts, each group taking as many of the card's SMs as
    its item has tiles, the one with the fewest rounds a CTA walks (items a
    group times tiles a CTA), then the fewest items a group walks (each item a
    group walks costs a CTA a read and a write of its weight-gradient
    partials, and its phases' fixed costs), then the fewest groups. Unlike
    the forward's plan it does not hold the items in flight to the L2 budget
    (``resident`` says whether they fit): on an NVIDIA H100 at the training
    shape, 16 groups of 8 CTAs took 13.4 ms where 4 groups of 32, which fit,
    took 20.0 (PERF.md).
    Raises where the shape is out of the kernel's range or the shared memory
    does not fit."""
    if batch < 1 or frames < 1 or not dils:
        raise ValueError(f"tcn_train_backward: B={batch}, K={frames}, {len(dils)} blocks")
    if not 1 <= taps <= TRUNK_MAX_TAPS or len(dils) > TRUNK_MAX_BLOCKS:
        raise ValueError(f"tcn_train_backward: {taps} taps and {len(dils)} blocks; the kernel "
                         f"takes at most {TRUNK_MAX_TAPS} taps and {TRUNK_MAX_BLOCKS} blocks")
    if min(dils) < 1 or max(dils) > MAX_DILATION:
        raise ValueError(f"tcn_train_backward: dilations {tuple(dils)} outside [1, {MAX_DILATION}]")
    if cb < 8 or ch < 8 or cb % 8 or ch % 8:
        raise ValueError(f"tcn_train_backward: cb={cb} and ch={ch} must be multiples of 8")
    halo = (taps - 1) * max(dils)
    smem = backward_smem_bytes(taps, max(dils), cb, ch)
    if smem > smem_optin or smem + _RESERVED_BYTES > smem_per_sm:
        raise ValueError(f"tcn_train_backward: {smem} bytes of shared memory a CTA; the card has "
                         f"{smem_optin} a block")
    tiles = -(-frames // TRUNK_TILE_ROWS)
    item_bytes = frames * (2 * 2 * ch + 2 * 4 * cb)
    slab_bytes = 2 * frames * (3 * ch + 2 * cb)
    n = len(dils)
    vdim = max(ch, 2 * cb)
    weight_bytes = n * (2 * cb * ch * 2 + 2 * ch * 2 * cb + 4 * taps * ch + 4 * 10 * vdim)
    budget = int(TRUNK_L2_SHARE * l2_bytes)
    best = None
    for groups in range(1, min(batch, sms) + 1):
        ctas = min(tiles, sms // groups)
        visits = -(-batch // groups)
        key = (visits * -(-tiles // ctas), visits, groups)
        if best is None or key < best[0]:
            best = (key, groups, ctas)
    _, groups, ctas = best
    wtiles = _weight_tiles(cb, ch)
    partial = 4 * groups * ctas * n * (wtiles * TRUNK_TILE_ROWS * BWD_TILE_COLS
                                       + (BWD_VEC_ROWS + taps) * vdim)
    return BackwardPlan(groups, ctas, tiles, smem, item_bytes, slab_bytes, weight_bytes, budget,
                        halo, wtiles, partial)


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
    if use_plain(h0):
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
                             taps: int = 3, storage: torch.dtype = torch.bfloat16,
                             ctas: int | None = None, groups: int = 1):
    """Plain version of :func:`tcn_train_backward`, on any device: the TPU
    backward's arithmetic, rounding to ``storage`` where it stores a slab.

    ``ctas`` (with ``groups``) sums in the kernel's order for a plan of that
    many CTAs a group, a model of its reductions: each item's gLN means from
    each CTA's partial over the 128-row tiles it owns, the partials in rank
    order; each weight gradient and column sum from each CTA's partial over
    its tiles of its items (items in the order the group walks them), the
    partials in CTA order. By default each is one tensor sum."""
    b, k, cb, ch, n = _check_backward(dskip, hb, st, we, wdw, wcat, vecs, dils, taps)
    dev = dskip.device
    inv_n = torch.tensor(1.0 / (k * ch), dtype=torch.float32, device=dev)
    rows = torch.arange(k, device=dev)
    tiles = -(-k // TRUNK_TILE_ROWS)
    spans = None  # per CTA, in CTA order: its (item, first row, end row), in walking order
    if ctas is not None:
        spans = [[(item, t * TRUNK_TILE_ROWS, min((t + 1) * TRUNK_TILE_ROWS, k))
                  for item in range(g, b, groups) for t in range(rank, tiles, ctas)]
                 for g in range(groups) for rank in range(ctas)]

    def fsum(contrib):
        """The sum over items and frames of ``contrib(items, r0, r1)``, the
        contribution of frames ``[r0, r1)`` of ``items`` (a slice)."""
        if spans is None:
            return contrib(slice(None), 0, k)
        total = None
        for cta in spans:
            part = None
            for item, r0, r1 in cta:
                c = contrib(slice(item, item + 1), r0, r1)
                part = c if part is None else part + c
            if part is not None:
                total = part if total is None else total + part
        return total

    def mean(x: torch.Tensor) -> torch.Tensor:
        """Per item, the sum of ``x`` over (K, ch) times ``inv_n``, ``[B, 1, 1]``."""
        if ctas is None:
            s = x.sum(dim=(1, 2))
        else:
            rank = (rows // TRUNK_TILE_ROWS) % ctas
            part = x.new_zeros((b, ctas)).index_add_(1, rank, x.sum(dim=2))
            s = part[:, 0]
            for r in range(1, ctas):
                s = s + part[:, r]
        return (s * inv_n)[:, None, None]

    def rnd(x: torch.Tensor) -> torch.Tensor:
        return x.to(storage).float()

    def shift(x: torch.Tensor, off: int) -> torch.Tensor:
        """``x[:, u + off]`` along frames, zero outside ``[0, K)``."""
        if off >= 0:
            return F.pad(x[:, off:], (0, 0, 0, min(off, k)))
        return F.pad(x[:, : max(k + off, 0)], (0, 0, min(-off, k), 0))

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
        dwcat[j] = fsum(lambda i, r0, r1: torch.einsum("bkc,bko->co", n2[i, r0:r1], drs[i, r0:r1]))
        dvec[j, 6, : 2 * cb] = fsum(lambda i, r0, r1: drs[i, r0:r1].sum(dim=(0, 1)))
        prod = dn2 * xh2
        dvec[j, 4, :ch] = fsum(lambda i, r0, r1: prod[i, r0:r1].sum(dim=(0, 1)))
        dvec[j, 5, :ch] = fsum(lambda i, r0, r1: dn2[i, r0:r1].sum(dim=(0, 1)))
        dxh2 = dn2 * g2
        ma2 = mean(dxh2)
        mb2 = mean(dxh2 * xh2)

        # P4: gLN2 and PReLU2 backward
        dt2 = s2 * (rnd(dxh2) - ma2 - xh2 * mb2)
        ddc = torch.where(d >= 0, dt2, a2 * dt2)
        prod = dt2 * torch.clamp(d, max=0.0)
        dvec[j, 9, :ch] = fsum(lambda i, r0, r1: prod[i, r0:r1].sum(dim=(0, 1)))
        dvec[j, 3, :ch] = fsum(lambda i, r0, r1: ddc[i, r0:r1].sum(dim=(0, 1)))
        dd = rnd(ddc)

        # P5: the dilated taps transposed, dw, gLN1 sums
        dn1 = torch.zeros_like(dd)
        for t, rel in enumerate(rels):
            dn1 = dn1 + w[t] * shift(dd, -rel)
            prod = dd * shift(av1 * t1 + bv1, rel)  # the normalised input, zero-padded
            dwdw[j, t] = fsum(lambda i, r0, r1: prod[i, r0:r1].sum(dim=(0, 1)))
        xh1 = (t1 - mu1) * s1
        prod = dn1 * xh1
        dvec[j, 1, :ch] = fsum(lambda i, r0, r1: prod[i, r0:r1].sum(dim=(0, 1)))
        dvec[j, 2, :ch] = fsum(lambda i, r0, r1: dn1[i, r0:r1].sum(dim=(0, 1)))
        dxh1 = dn1 * g1
        ma1 = mean(dxh1)
        mb1 = mean(dxh1 * xh1)

        # P6: gLN1 and PReLU1 backward, the expand product's gradients
        dt1 = s1 * (rnd(dxh1) - ma1 - xh1 * mb1)
        dt1p = torch.where(y >= 0, dt1, a1 * dt1)
        prod = dt1 * torch.clamp(y, max=0.0)
        dvec[j, 8, :ch] = fsum(lambda i, r0, r1: prod[i, r0:r1].sum(dim=(0, 1)))
        dvec[j, 0, :ch] = fsum(lambda i, r0, r1: dt1p[i, r0:r1].sum(dim=(0, 1)))
        dt1p = rnd(dt1p)
        dwe[j] = fsum(lambda i, r0, r1: torch.einsum("bkc,bko->co", h[i, r0:r1], dt1p[i, r0:r1]))
        dh = dh + dt1p @ we_j.T
    return dh, dwe, dwdw, dwcat, dvec


def tcn_train_backward(dskip, hb, st, we, wdw, wcat, vecs, *, dils: Sequence[int],
                       taps: int = 3):
    """The trunk's backward: ``(dh0 [B, K, cb], dwe, dwdw, dwcat, dvec)``, all
    fp32, the gradients of ``h0`` and of the canonical arrays given the skip
    sum's gradient ``dskip [B, K, cb]`` and :func:`tcn_train_forward`'s
    residuals ``hb``, ``st``. ``we``, ``wcat`` are used in bf16."""
    if use_plain(dskip):
        return tcn_train_backward_plain(dskip, hb, st, we, wdw, wcat, vecs, dils=dils, taps=taps)
    grads = launch_backward(dskip, hb, st, we, wdw, wcat, vecs, dils=dils, taps=taps,
                            name="tcn_train_backward")
    tcn_train_backward.launches += 1
    return grads


def launch_backward(dskip, hb, st, we, wdw, wcat, vecs, *, dils: Sequence[int], taps: int,
                    name: str, timing: torch.Tensor | None = None):
    """Run ``csrc/tcn_train_backward.cu`` on CUDA tensors (checked, or raises)
    in one cooperative launch of :func:`backward_plan`'s grid. ``timing``, an
    int64 ``[grid, len(TRUNK_BWD_LAPS)]`` tensor, receives each CTA's
    nanoseconds in each part of ``TRUNK_BWD_LAPS``."""
    tensors = (dskip, hb, st, we, wdw, wcat, vecs)
    if dskip.device.type != "cuda" or any(t.device != dskip.device for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    b, k, cb, ch, n = _check_backward(dskip, hb, st, we, wdw, wcat, vecs, dils, taps)
    if hb.dtype != torch.bfloat16:
        raise TypeError(f"{name}: hb must be bf16, got {hb.dtype}")
    dev = dskip.device
    plan = backward_plan(b, k, cb, ch, taps, dils, **_device_limits(dev))
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
    slabs = torch.empty(plan.groups * k * (5 * ch + 2 * cb), dtype=torch.bfloat16, device=dev)
    part = torch.empty(plan.groups * 2 * plan.ctas * 2, dtype=torch.float32, device=dev)
    wpart = torch.empty(plan.grid * n * plan.weight_tiles * TRUNK_TILE_ROWS * BWD_TILE_COLS,
                        dtype=torch.float32, device=dev)
    vpart = torch.empty(plan.grid * n * (BWD_VEC_ROWS + taps) * vdim, dtype=torch.float32,
                        device=dev)
    counters = torch.zeros(plan.groups + 1, dtype=torch.int32, device=dev)
    if timing is not None and (timing.shape != (plan.grid, len(TRUNK_BWD_LAPS))
                               or timing.dtype != torch.int64 or timing.device != dev):
        raise ValueError(f"{name}: timing must be int64 [{plan.grid}, {len(TRUNK_BWD_LAPS)}] "
                         f"on {dev}")
    dil_array = (ctypes.c_int * n)(*(int(d) for d in dils))
    with torch.cuda.device(dev):
        code = _build.library().sst_tcn_trunk_backward(
            hb.data_ptr(), st.data_ptr(), dskip.data_ptr(), dh.data_ptr(), we.data_ptr(),
            wdw.data_ptr(), wcat.data_ptr(), vecs.data_ptr(),
            ctypes.addressof(dil_array), dwe.data_ptr(), dwdw.data_ptr(), dwcat.data_ptr(),
            dvec.data_ptr(), slabs.data_ptr(), part.data_ptr(), wpart.data_ptr(),
            vpart.data_ptr(), counters.data_ptr(), 0 if timing is None else timing.data_ptr(),
            b, k, cb, ch, vdim, taps, n, plan.groups, plan.ctas,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, name)
    return dh, dwe, dwdw, dwcat, dvec


def trunk_backward_phase_ms(dskip, hb, st, we, wdw, wcat, vecs, *, dils: Sequence[int],
                            taps: int = 3) -> dict:
    """One timed run of the backward kernel on CUDA tensors: the mean over its
    CTAs of the milliseconds each spent in each part of ``TRUNK_BWD_LAPS``
    (``%globaltimer``), with the plan's groups and CTAs."""
    plan = backward_plan(hb.shape[1], hb.shape[2], hb.shape[3], we.shape[2], taps, dils,
                         **_device_limits(hb.device))
    timing = torch.zeros((plan.grid, len(TRUNK_BWD_LAPS)), dtype=torch.int64, device=hb.device)
    launch_backward(dskip, hb, st, we, wdw, wcat, vecs, dils=dils, taps=taps,
                    name="trunk_backward_phase_ms", timing=timing)
    ms = (timing.double().mean(dim=0) / 1e6).tolist()
    return {**dict(zip(TRUNK_BWD_LAPS, ms)), "groups": plan.groups, "ctas": plan.ctas}


tcn_train_backward.launches = 0


class _TrunkTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h0, we, wdw, wcat, vecs, dils, taps, storage):
        folded = fold_canonical(we, wdw, wcat, vecs, storage)
        # decided once: the backward may run on autograd's own thread
        plain = use_plain(h0)
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
                dvec.to(vecs.dtype), None, None, None)


def tcn_trunk_train(h0, we, wdw, wcat, vecs, *, dils: Sequence[int], taps: int = 3,
                    storage: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Differentiable trunk: the skip sum ``[B, K, cb]`` in ``storage``.

    ``h0 [B, K, cb]``; the canonical arrays of ``stack_canonical`` (fp32
    masters, cast inside); ``dils`` one dilation per block, at most 64.
    Gradients flow to ``h0`` and to every canonical array. Both passes run
    their plain versions where ``dispatch.use_plain`` says;
    ``storage=torch.float32`` (plain only) rounds nothing.
    """
    if storage != torch.bfloat16 and not use_plain(h0):
        raise ValueError(f"tcn_trunk_train: the kernels store bf16; storage {storage} needs "
                         "plain_versions()")
    return _TrunkTrain.apply(h0, we, wdw, wcat, vecs, tuple(int(d) for d in dils), taps, storage)
