"""Fused Conv-TasNet TCN trunk for serving (counterpart of ``ops/tcn_pallas.py``
and the forward-only helpers of ``ops/tcn_train_pallas.py``).

:func:`tcn_trunk_cuda` runs every dilated block of the trunk in
``csrc/tcn_trunk.cu`` and returns the skip sum. :func:`tcn_trunk_plain` is its
plain PyTorch version, which the wrapper takes where ``dispatch.use_plain``
says (a CPU tensor, or inside ``plain_versions()``); otherwise it launches
the kernel or raises. :func:`trunk_reference` is
the fp32 oracle over the canonical stack.

Per block ``j`` (``stack_tcn_weights``' arrays, gLN folded as in
``tcn_pallas._make_kernel``):

    t1  = prelu(h @ We + b_e)                        stats1 from fp32 t1, t1 stored bf16
    A1  = g1 / sigma1,  B1 = be1 - mu1 · A1
    t2  = prelu(Σ_t (A1 · w_t) · t1[k + t·d − pad] + B1 · Σ_t w_t + b_dw − edge)
                                                     stats2 from fp32 t2, t2 stored bf16
    rs  = (t2 @ Wg) / sigma2 + biasc − (mu2 / sigma2) · csum
    h   = bf16(h + rs[:, :cb]),  skip = bf16(skip + rs[:, cb:])

where a tap outside ``[0, K)`` reads zero and ``edge`` subtracts ``B1 · w_t``
for it (the SAME zero-padding is of the *normalised* tensor). Products take
bf16 operands with fp32 accumulation; statistics and epilogues are fp32. The
plain version rounds at exactly these places.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from .. import _build
from .dispatch import use_plain

__all__ = [
    "MAX_DILATION",
    "stack_canonical",
    "stack_tcn_weights",
    "fold_canonical",
    "trunk_reference",
    "trunk_forward_plain",
    "tcn_trunk_plain",
    "tcn_trunk_cuda",
    "TrunkPlan",
    "trunk_plan",
    "trunk_smem_bytes",
    "launch_trunk",
    "trunk_phase_ms",
]

MAX_DILATION = 64  # tcn_trunk_pallas' slab halo; its assert is kept
_EPS = 1e-8
# csrc/tcn_trunk.cu's and csrc/tcn_common.cuh's tiling (tests hold them to the source)
TRUNK_THREADS = 256  # two warpgroups a CTA
TRUNK_TILE_ROWS = 128  # rows a CTA tile: 64 a warpgroup
TRUNK_TILE_COLS = 256  # output columns a pass: one wgmma m64n256k16 a warpgroup
TRUNK_DEPTH = 64  # depth of a shared-memory stage of the product
TRUNK_STAGES = 3  # the product's ring of stages
TRUNK_SLICE = 64  # channels a (B) unit stages
TRUNK_MAX_TAPS = 8
TRUNK_MAX_BLOCKS = 256  # dilations carried in the launch parameters
TRUNK_L2_SHARE = 0.8  # of the L2: the budget for the items in flight and the weights
# the parts of a block csrc/tcn_trunk.cu times with %globaltimer (its enum Lap)
TRUNK_LAPS = ("A coefficients", "A products", "A epilogue", "B statistics", "B taps",
              "C products", "C epilogue", "waiting")
_RESERVED_BYTES = 2048  # a CTA's static shared memory and the system's reservation


@dataclasses.dataclass(frozen=True)
class TrunkPlan:
    """One cooperative launch of ``groups`` x ``ctas`` CTAs, one an SM: item
    ``i`` belongs to group ``i % groups`` (``groups`` items in flight), and
    CTA ``rank`` of a group owns the 128-row tiles ``rank, rank + ctas, ...``
    of its item in every phase."""

    groups: int
    ctas: int
    tiles: int  # 128-row tiles an item
    smem: int  # dynamic shared memory a CTA
    item_bytes: int  # one item in flight in L2: h, skip, t1, t2
    weight_bytes: int  # every block's weights
    l2_budget: int
    halo: int  # rows (B) stages beyond a tile: (taps - 1) x the largest dilation

    @property
    def grid(self) -> int:
        return self.groups * self.ctas

    @property
    def resident(self) -> bool:
        """Whether the items in flight and the weights fit the L2 budget (a
        single item that does not still runs, through device memory)."""
        return self.groups * self.item_bytes + self.weight_bytes <= self.l2_budget


def trunk_smem_bytes(taps: int, max_dil: int, cb: int, ch: int) -> int:
    """Dynamic shared memory of ``csrc/tcn_trunk.cu``: a staging area, the
    product's ring of stages or (B)'s two buffers of a tile's rows and halo for
    a 64-channel slice, whichever is larger, aligned to 1,024 bytes, then a
    block's per-column vectors and depthwise weights in fp32, ``(6 + taps) ch
    + 4 cb`` of them."""
    span = TRUNK_TILE_ROWS + (taps - 1) * max_dil
    buf = -(-(span * TRUNK_SLICE * 2) // 1024) * 1024
    ring = TRUNK_STAGES * (TRUNK_TILE_ROWS + TRUNK_TILE_COLS) * TRUNK_DEPTH * 2
    return 1024 + max(ring, 2 * buf) + 4 * ((6 + taps) * ch + 4 * cb)  # 1,024 to align it


def trunk_plan(batch: int, frames: int, cb: int, ch: int, taps: int, dils: Sequence[int], *,
               sms: int, smem_optin: int, smem_per_sm: int, l2_bytes: int) -> TrunkPlan:
    """The trunk's launch plan on a card with ``sms`` SMs, ``smem_optin`` bytes
    of shared memory a block, ``smem_per_sm`` an SM and ``l2_bytes`` of L2.

    Of the group counts whose items in flight (their h, skip, t1 and t2) and
    the weights fit ``TRUNK_L2_SHARE`` of the L2 (one group always may), the
    one with the fewest rounds a CTA walks, items a group times tiles a CTA,
    each group taking as many of the card's SMs as its item has tiles; the
    fewest groups among equals. Raises where the shared memory does not fit.
    """
    if batch < 1 or frames < 1 or not dils:
        raise ValueError(f"tcn_trunk: B={batch}, K={frames}, {len(dils)} blocks")
    if not 1 <= taps <= TRUNK_MAX_TAPS or len(dils) > TRUNK_MAX_BLOCKS:
        raise ValueError(f"tcn_trunk: {taps} taps and {len(dils)} blocks; the kernel takes at "
                         f"most {TRUNK_MAX_TAPS} taps and {TRUNK_MAX_BLOCKS} blocks")
    halo = (taps - 1) * max(dils)
    smem = trunk_smem_bytes(taps, max(dils), cb, ch)
    if smem > smem_optin or smem + _RESERVED_BYTES > smem_per_sm:
        raise ValueError(f"tcn_trunk: {smem} bytes of shared memory a CTA; the card has "
                         f"{smem_optin} a block")
    tiles = -(-frames // TRUNK_TILE_ROWS)
    item_bytes = 2 * frames * (2 * cb + 2 * ch)
    n = len(dils)
    weight_bytes = n * (2 * cb * ch + 2 * ch * 2 * cb + 4 * taps * ch + 4 * 8 * max(ch, 2 * cb))
    budget = int(TRUNK_L2_SHARE * l2_bytes)
    best = None
    for groups in range(1, min(batch, sms) + 1):
        if groups > 1 and groups * item_bytes + weight_bytes > budget:
            break
        ctas = min(tiles, sms // groups)
        rounds = -(-batch // groups) * -(-tiles // ctas)
        if best is None or rounds < best[0]:
            best = (rounds, groups, ctas)
    _, groups, ctas = best
    return TrunkPlan(groups, ctas, tiles, smem, item_bytes, weight_bytes, budget, halo)


@functools.lru_cache(maxsize=8)
def _device_limits(device: torch.device) -> dict:
    props = torch.cuda.get_device_properties(device)
    return {
        "sms": props.multi_processor_count,
        "smem_optin": props.shared_memory_per_block_optin,
        "smem_per_sm": props.shared_memory_per_multiprocessor,
        "l2_bytes": props.L2_cache_size,
    }


def stack_canonical(params: Mapping[str, torch.Tensor], *, blocks: int, repeats: int):
    """Stack the per-block parameters of a ``ConvTasNet`` (dotted names, as in
    ``named_parameters()``) into the canonical arrays, all fp32:

      we   [N, cb, ch]   expand 1x1 kernels
      wdw  [N, taps, ch] depthwise kernels
      wcat [N, ch, 2cb]  concat(res, skip) 1x1 kernels
      vecs [N, 10, vdim] per-block vectors (vdim = max(ch, 2cb)):
        0: expand bias   1: norm1 gamma  2: norm1 beta   3: depthwise bias
        4: norm2 gamma   5: norm2 beta   6: bcat (padded) 7: zeros
        8: prelu1 alpha (broadcast)      9: prelu2 alpha (broadcast)
    """
    we, wdw, wcat, vecs = [], [], [], []
    for r in range(repeats):
        for x in range(blocks):
            pre = f"tcn_{r}_{x}."

            def get(name: str) -> torch.Tensor:
                return params[pre + name].float()

            w_cat = torch.cat([get("res_out.kernel")[0], get("skip_out.kernel")[0]], dim=1)
            b_cat = torch.cat([get("res_out.bias"), get("skip_out.bias")])
            ch, out2 = w_cat.shape
            vdim = max(ch, out2)
            ones = torch.ones(vdim, device=w_cat.device)

            def row(v: torch.Tensor, vdim: int = vdim) -> torch.Tensor:
                return F.pad(v, (0, vdim - v.shape[0]))

            we.append(get("expand.kernel")[0])
            wdw.append(get("depthwise.kernel")[:, 0, :])
            wcat.append(w_cat)
            vecs.append(torch.stack([
                row(get("expand.bias")),
                row(get("norm1.gamma")),
                row(get("norm1.beta")),
                row(get("depthwise.bias")),
                row(get("norm2.gamma")),
                row(get("norm2.beta")),
                row(b_cat),
                torch.zeros_like(ones),
                get("prelu1.alpha")[0] * ones,
                get("prelu2.alpha")[0] * ones,
            ]))
    return torch.stack(we), torch.stack(wdw), torch.stack(wcat), torch.stack(vecs)


def stack_tcn_weights(params: Mapping[str, torch.Tensor], *, blocks: int, repeats: int):
    """The kernel's input arrays ``(we, wdw, wg, vecs)``, derived from
    :func:`stack_canonical` as ``tcn_pallas.stack_tcn_weights`` derives them
    (:func:`fold_canonical`)."""
    return fold_canonical(*stack_canonical(params, blocks=blocks, repeats=repeats))


def fold_canonical(we, wdw, wcat, cvecs, dtype: torch.dtype = torch.bfloat16):
    """The canonical arrays folded for the trunk kernel, gLN2's gamma into the
    res|skip product:

      we   [N, cb, ch]    ``dtype`` - expand 1x1 kernels
      wdw  [N, taps, ch]  fp32 - depthwise kernels
      wg   [N, ch, 2cb]   ``dtype`` - gamma2-folded concat(res, skip)
      vecs [N, 8, vdim]   fp32 - per-block vectors:
        0: expand bias   1: norm1 gamma  2: norm1 beta  3: depthwise bias
        4: beta2 @ W_cat + bias_cat (biasc)  5: colsum(gamma2 * W_cat) (csum)
        6: prelu1 alpha (broadcast)     7: prelu2 alpha (broadcast)

    ``biasc`` and ``csum`` are taken from the fp32 fold; only ``we`` and ``wg``
    are rounded to ``dtype`` (bf16 for the kernel).
    """
    we, wdw, wcat, cvecs = (t.float() for t in (we, wdw, wcat, cvecs))
    ch, out2 = wcat.shape[1:]
    vdim = cvecs.shape[2]
    g2, b2, bcat = cvecs[:, 4, :ch], cvecs[:, 5, :ch], cvecs[:, 6, :out2]
    wgf = g2[:, :, None] * wcat

    def pad(v: torch.Tensor) -> torch.Tensor:
        return F.pad(v, (0, vdim - v.shape[1]))

    vecs = torch.stack(
        [
            cvecs[:, 0],
            cvecs[:, 1],
            cvecs[:, 2],
            cvecs[:, 3],
            pad(torch.einsum("nc,nco->no", b2, wcat) + bcat),
            pad(wgf.sum(dim=1)),
            cvecs[:, 8],
            cvecs[:, 9],
        ],
        dim=1,
    )
    return we.to(dtype), wdw, wgf.to(dtype), vecs


def trunk_reference(h0, we, wdw, wcat, vecs, *, dils: Sequence[int], taps: int = 3):
    """Reference of the trunk over the canonical arrays (differentiable), in
    their dtype (fp32, or float64 as an oracle): the skip sum ``[B, K, cb]``."""
    k, cb = h0.shape[1:]
    ch = we.shape[2]
    h = h0.to(we.dtype)
    skip = torch.zeros_like(h)
    for j, d in enumerate(dils):
        be, g1, b1, bdw = (vecs[j, i, :ch] for i in range(4))
        g2, b2 = vecs[j, 4, :ch], vecs[j, 5, :ch]
        bcat = vecs[j, 6, : 2 * cb]
        a1, a2 = vecs[j, 8, 0], vecs[j, 9, 0]
        t1p = h @ we[j] + be
        t1 = torch.where(t1p >= 0, t1p, a1 * t1p)
        n1 = g1 * (t1 - _mean(t1)) * _inv_std(t1) + b1
        pad = (taps - 1) * d // 2
        n1p = F.pad(n1, (0, 0, pad, pad))
        dconv = sum(wdw[j, t] * n1p[:, t * d : t * d + k, :] for t in range(taps)) + bdw
        t2 = torch.where(dconv >= 0, dconv, a2 * dconv)
        n2 = g2 * (t2 - _mean(t2)) * _inv_std(t2) + b2
        rs = n2 @ wcat[j] + bcat
        h = h + rs[..., :cb]
        skip = skip + rs[..., cb:]
    return skip


def _mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2), keepdim=True)


def _inv_std(x: torch.Tensor) -> torch.Tensor:
    mu = _mean(x)
    return torch.rsqrt(torch.clamp((x * x).mean(dim=(1, 2), keepdim=True) - mu * mu, min=0.0) + _EPS)


def _check(h0, we, wdw, wg, vecs, dils, taps, storage=torch.bfloat16):
    """Validate the trunk's inputs as ``tcn_trunk_pallas`` asserts them, plus
    dtypes (``we`` and ``wg`` in the storage dtype) and shapes; returns
    ``(batch, frames, cb, ch, blocks)``."""
    if h0.dim() != 3 or we.dim() != 3 or wdw.dim() != 3 or wg.dim() != 3 or vecs.dim() != 3:
        raise ValueError("tcn_trunk: expected h0 [B, K, cb], we, wdw, wg and vecs of rank 3")
    b, k, cb = h0.shape
    n, _, ch = we.shape
    if len(dils) != n:
        raise ValueError(f"tcn_trunk: {len(dils)} dilations for {n} blocks")
    if max(dils) > MAX_DILATION or min(dils) < 1:
        raise ValueError(f"tcn_trunk: dilations {tuple(dils)} outside [1, {MAX_DILATION}]")
    want = {"we": (n, cb, ch), "wdw": (n, taps, ch), "wg": (n, ch, 2 * cb)}
    for name, t in (("we", we), ("wdw", wdw), ("wg", wg)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"tcn_trunk: {name} {tuple(t.shape)}, expected {want[name]}")
    if vecs.shape[0] != n or vecs.shape[1] != 8 or vecs.shape[2] < max(ch, 2 * cb):
        raise ValueError(f"tcn_trunk: vecs {tuple(vecs.shape)}, expected [{n}, 8, >= {max(ch, 2 * cb)}]")
    if we.dtype != storage or wg.dtype != storage:
        raise TypeError(f"tcn_trunk: we and wg must be {storage}, got {we.dtype} and {wg.dtype}")
    if wdw.dtype != torch.float32 or vecs.dtype != torch.float32:
        raise TypeError(f"tcn_trunk: wdw and vecs must be fp32, got {wdw.dtype} and {vecs.dtype}")
    if not h0.is_floating_point() or b < 1 or k < 1:
        raise ValueError(f"tcn_trunk: h0 {tuple(h0.shape)} {h0.dtype}")
    return b, k, cb, ch, n


def tcn_trunk_plain(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3):
    """Plain version of :func:`tcn_trunk_cuda`, on any device: the same
    roundings (h, skip, t1 and t2 stored bf16; statistics from the fp32
    values; products of bf16 operands in fp32)."""
    return trunk_forward_plain(h0, we, wdw, wg, vecs, dils=dils, taps=taps)[0]


def trunk_forward_plain(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3,
                        storage: torch.dtype = torch.bfloat16, residuals: bool = False,
                        ctas: int | None = None):
    """The trunk in plain PyTorch with its roundings to ``storage`` (bf16 for
    the kernels): ``(skip, hb, st)``. ``residuals=True`` also returns the
    training forward's residuals, each block's input ``hb [N, B, K, cb]``
    (``storage``) and ``st [N, B, 4]`` fp32 ``(mu1, 1/sigma1, mu2, 1/sigma2)``;
    else both are ``None``. ``ctas`` sums the statistics in the kernel's
    order for a group of that many CTAs (each CTA's partial over the 128-row
    tiles it owns, the partials added in rank order), a model of the
    kernel's reduction; by default they are summed as one tensor sum."""
    b, k, cb, ch, n = _check(h0, we, wdw, wg, vecs, dils, taps, storage)
    inv_n = torch.tensor(1.0 / (k * ch), dtype=torch.float32, device=h0.device)
    rows = torch.arange(k, device=h0.device)
    h = h0.to(storage)
    skip = torch.zeros_like(h)
    hb = h.new_empty((n, b, k, cb)) if residuals else None
    st = torch.empty((n, b, 4), dtype=torch.float32, device=h0.device) if residuals else None
    for j, d in enumerate(dils):
        v = vecs[j]
        b_e, g1, be1, b_dw = v[0, :ch], v[1, :ch], v[2, :ch], v[3, :ch]
        biasc, csum = v[4, : 2 * cb], v[5, : 2 * cb]
        a1, a2 = v[6, :ch], v[7, :ch]
        w = [wdw[j, t] for t in range(taps)]
        if residuals:
            hb[j] = h

        y = h.float() @ we[j].float() + b_e
        t1 = torch.where(y >= 0, y, a1 * y)
        mu1, st1 = _folded_stats(t1, inv_n, ctas)
        av1 = g1 * st1[:, None]  # [B, ch]
        bv1 = be1 - mu1[:, None] * av1
        wsum = w[0]
        for t in range(1, taps):
            wsum = wsum + w[t]
        b_eff = bv1 * wsum + b_dw

        pad = (taps - 1) * d // 2
        t1p = F.pad(t1.to(storage).float(), (0, 0, pad, (taps - 1) * d - pad))
        pre = b_eff[:, None, :]
        for t in range(taps):
            pre = pre + (av1 * w[t])[:, None, :] * t1p[:, t * d : t * d + k]
        for t in range(taps):
            off = t * d - pad
            if off:
                invalid = ((rows + off < 0) | (rows + off >= k)).float()
                pre = pre - (bv1 * w[t])[:, None, :] * invalid[None, :, None]
        t2 = torch.where(pre >= 0, pre, a2 * pre)
        mu2, st2 = _folded_stats(t2, inv_n, ctas)
        bias2 = biasc - (mu2 * st2)[:, None] * csum  # [B, 2cb]
        if residuals:
            st[j] = torch.stack([mu1, st1, mu2, st2], dim=1)

        rs = (t2.to(storage).float() @ wg[j].float()) * st2[:, None, None] + bias2[:, None, :]
        h = (h.float() + rs[..., :cb]).to(storage)
        skip = (skip.float() + rs[..., cb:]).to(storage)
    return skip, hb, st


def _folded_stats(x: torch.Tensor, inv_n: torch.Tensor, ctas: int | None = None):
    """Per-item one-pass gLN statistics ``(mu, 1/sigma)`` of fp32 ``x``, each
    ``[B]``; with ``ctas``, the sums in the kernel's order (see
    :func:`trunk_forward_plain`)."""
    if ctas is None:
        s, sq = x.sum(dim=(1, 2)), (x * x).sum(dim=(1, 2))
    else:
        rank = (torch.arange(x.shape[1], device=x.device) // TRUNK_TILE_ROWS) % ctas
        rows = torch.stack([x.sum(dim=2), (x * x).sum(dim=2)])  # [2, B, K]
        part = rows.new_zeros((2, x.shape[0], ctas)).index_add_(2, rank, rows)
        s, sq = part[0, :, 0], part[1, :, 0]
        for r in range(1, ctas):
            s, sq = s + part[0, :, r], sq + part[1, :, r]
    mu = s * inv_n
    var = torch.clamp(sq * inv_n - mu * mu, min=0.0)
    return mu, 1.0 / torch.sqrt(var + _EPS)


def tcn_trunk_cuda(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3) -> torch.Tensor:
    """Skip-connection sum ``[B, K, cb]`` bf16 of the whole trunk.

    ``h0``: ``[B, K, cb]`` (any float dtype, cast to bf16); the weight arrays
    come from :func:`stack_tcn_weights`; ``dils`` holds one dilation per
    block, at most 64. On a CUDA tensor ``cb`` and ``ch`` must be multiples
    of 8 (16-byte rows for the kernel's tile loads).
    """
    if use_plain(h0):
        return tcn_trunk_plain(h0, we, wdw, wg, vecs, dils=dils, taps=taps)
    skip, _, _ = launch_trunk(h0, we, wdw, wg, vecs, dils=dils, taps=taps, name="tcn_trunk_cuda")
    tcn_trunk_cuda.launches += 1
    return skip


tcn_trunk_cuda.launches = 0


def launch_trunk(h0, we, wdw, wg, vecs, *, dils, taps, name: str, residuals: bool = False,
                 timing: torch.Tensor | None = None):
    """Run ``csrc/tcn_trunk.cu`` on CUDA tensors (checked, or raises): ``(skip,
    hb, st)``, the residuals from its training mode when ``residuals`` (see
    ``trunk_forward_plain``), else ``None``. ``timing``, an int64 ``[grid,
    8]`` tensor of the plan's grid, receives each CTA's nanoseconds in each
    part of ``TRUNK_LAPS``."""
    if h0.device.type != "cuda" or any(t.device != h0.device for t in (we, wdw, wg, vecs)):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in (h0, we, wdw, wg, vecs)]}")
    b, k, cb, ch, n = _check(h0, we, wdw, wg, vecs, dils, taps)
    if cb % 8 or ch % 8:
        raise ValueError(f"{name}: cb={cb} and ch={ch} must be multiples of 8")
    plan = trunk_plan(b, k, cb, ch, taps, dils, **_device_limits(h0.device))
    h0 = h0.to(torch.bfloat16).contiguous()  # read only
    h = torch.empty_like(h0)  # the carry
    skip = torch.empty_like(h0)
    dev = h0.device
    t1 = torch.empty((plan.groups, k, ch), dtype=torch.bfloat16, device=dev)
    t2 = torch.empty_like(t1)
    part = torch.empty((plan.groups * 2 * plan.ctas, 2), dtype=torch.float32, device=dev)
    counters = torch.zeros(plan.groups, dtype=torch.int32, device=dev)
    # both operands of the products K-major: the weights transposed
    we_t = we.transpose(1, 2).contiguous()
    wg_t = wg.transpose(1, 2).contiguous()
    wdw, vecs = wdw.contiguous(), vecs.contiguous()
    if timing is not None and (timing.shape != (plan.grid, len(TRUNK_LAPS))
                               or timing.dtype != torch.int64 or timing.device != dev):
        raise ValueError(f"{name}: timing must be int64 [{plan.grid}, {len(TRUNK_LAPS)}] on {dev}")
    dil_array = (ctypes.c_int * n)(*(int(d) for d in dils))
    args = [h0.data_ptr(), h.data_ptr(), skip.data_ptr(), t1.data_ptr(), t2.data_ptr(),
            part.data_ptr(), counters.data_ptr(), we_t.data_ptr(), wdw.data_ptr(),
            wg_t.data_ptr(), vecs.data_ptr(), ctypes.addressof(dil_array),
            0 if timing is None else timing.data_ptr()]
    hb = st = None
    if residuals:
        hb = torch.empty((n, b, k, cb), dtype=torch.bfloat16, device=dev)
        st = torch.empty((n, b, 4), dtype=torch.float32, device=dev)
        args += [hb.data_ptr(), st.data_ptr()]
    lib = _build.library()
    entry = lib.sst_tcn_trunk_train if residuals else lib.sst_tcn_trunk
    with torch.cuda.device(dev):
        code = entry(*args, b, k, cb, ch, vecs.shape[2], taps, n, plan.groups, plan.ctas,
                     torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    return skip, hb, st


def trunk_phase_ms(h0, we, wdw, wg, vecs, *, dils: Sequence[int], taps: int = 3,
                   residuals: bool = False) -> dict:
    """One timed run of the trunk kernel on CUDA tensors: the mean over its CTAs
    of the milliseconds each spent in each part of ``TRUNK_LAPS``
    (``%globaltimer``), with the plan's groups and CTAs."""
    plan = trunk_plan(h0.shape[0], h0.shape[1], h0.shape[2], we.shape[2], taps, dils,
                      **_device_limits(h0.device))
    timing = torch.zeros((plan.grid, len(TRUNK_LAPS)), dtype=torch.int64, device=h0.device)
    launch_trunk(h0, we, wdw, wg, vecs, dils=dils, taps=taps, name="trunk_phase_ms",
                 residuals=residuals, timing=timing)
    ms = (timing.double().mean(dim=0) / 1e6).tolist()
    return {**dict(zip(TRUNK_LAPS, ms)), "groups": plan.groups, "ctas": plan.ctas}
