"""BiLSTM training recurrence (counterpart of ``ops/lstm_train_pallas.py``).

:func:`bilstm_train` is one differentiable BiLSTM layer over the stacked
direction parameters of ``models.blstm.BiLSTM`` (``kernel [2, F, 4H]``,
``recurrent [2, H, 4H]``, ``bias [2, 4H]``; direction 1 runs backwards in
time), a :class:`torch.autograd.Function` whose two recurrences are CUDA
kernels:

- :func:`lstm_train_forward` — the forward, storing the post-activation gates
  and the cell states as residuals: the training mode of
  ``csrc/lstm_recurrence.cu``, one cooperative launch for all steps (per row
  slice of 256), tiled by ``lstm_cuda.forward_plan``;
- :func:`lstm_train_backward` — backward through time, emitting the
  pre-activation gate gradients: ``csrc/lstm_train_backward.cu``, one
  cooperative launch for all steps (per row slice of 256, as the forward;
  a batch of several slices copies each slice's rows out and back), tiled
  by :func:`backward_plan`.

Each has a plain PyTorch version (a Python loop over time, the same
roundings), which the wrapper takes where ``dispatch.use_plain`` says (a CPU
tensor, or inside ``plain_versions()``); otherwise it launches the kernel or
raises. The input projection and the gradients of ``x``, ``kernel``,
``recurrent`` and ``bias`` are large ``torch`` matrix products outside the
kernels, as the reference leaves them to XLA. :func:`bilstm_reference` is the same layer by autograd through a
plain fp32 loop (the counterpart of the ``lax.scan`` BiLSTM).

Numerics follow the reference: ``xw = bf16(x @ W)`` taken to fp32, plus the
bias, rounded to the compute dtype; gates, hidden states and ``dgates``
stored in the compute dtype; cell states and the (h, c) and (dh, dc) carries
in fp32; products read compute-dtype operands and accumulate in fp32.

Layout: every residual is ``[D, B, T, ·]`` at real time ``t``; a direction
runs over the whole padded length, and its "step before" is ``t - 1``
forwards and ``t + 1`` backwards. ``keep [2, B, T]`` (sequence-packed rows,
``models.blstm.segment_keep``) is indexed by each direction's own scan step,
as in the reference: a 0 gates the (h, c) carry, and in the backward the
(dh, dc) carry, to zero at that step.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .dispatch import use_plain
from .lstm_cuda import (
    _KERNEL_DTYPES,
    _check_shapes,
    _device_limits,
    _forward_launch,
    forward_plan,
    resident_tiling,
    row_slices,
)

__all__ = [
    "BackwardPlan",
    "backward_plan",
    "backward_smem_bytes",
    "bilstm_train",
    "bilstm_reference",
    "lstm_train_forward",
    "lstm_train_forward_plain",
    "lstm_train_backward",
    "lstm_train_backward_plain",
]

BIDIRECTIONAL = (False, True)  # direction 1 runs backwards in time
REVERSE_MASK = 0b10  # the kernels' reverse_mask for BIDIRECTIONAL

# The backward kernel's tiling (csrc/lstm_train_backward.cu): a block owns 16
# hidden units of one direction for `groups` groups of 16 batch rows, and
# stages dgates 256 columns at a time in fp32 (three buffers deep) and 1,024
# in bf16 (one buffer, through registers); 256 threads, and one block an SM:
# the launch bounds give the fp32 tile and the bf16 chunk the registers they
# need. With 16 units a block every H <= 1024 fits 132 SMs: 2 x 64 unit
# slices, each owning all of B's rows in at most 16 groups.
BWD_ROWS, BWD_UNITS, BWD_MAX_GROUPS = 16, 16, 16
BWD_CHUNK = {False: 256, True: 1024}  # by bf16
BWD_BLOCKS_PER_SM = 1
BWD_MAX_HIDDEN = 1024
BWD_PARTIAL_BYTES = 8 * BWD_ROWS * BWD_UNITS * 4  # 8 warps' fp32 partial sums


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """Launch plan of :func:`lstm_train_backward`'s persistent kernel."""

    groups: int  # groups of 16 rows a block owns
    resident: bool  # U's slice stays in shared memory (else streamed from L2)
    smem: int  # dynamic shared memory a block, bytes (the kernel sizes its own)
    unit_blocks: int
    row_blocks: int
    blocks_per_sm: int  # how many fit an SM by shared memory and registers

    @property
    def blocks(self) -> int:
        return 2 * self.row_blocks * self.unit_blocks


def backward_smem_bytes(hidden: int, bf16: bool, resident: bool) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out
    (``smem_bytes`` in the .cu file), for choosing the plan: the warps'
    partial sums, the staging buffers (three in fp32, one in bf16), each a
    dgates chunk and, when U is streamed, a chunk of U; U's slice if resident."""
    size, pad, buffers, chunk = (2, 8, 1, BWD_CHUNK[True]) if bf16 else (4, 8, 3, BWD_CHUNK[False])
    columns = -(-4 * hidden // chunk) * chunk
    buffer = BWD_ROWS * (chunk + pad) + (0 if resident else BWD_UNITS * (chunk + pad))
    u_resident = BWD_UNITS * (columns + pad) if resident else 0
    return BWD_PARTIAL_BYTES + size * (buffers * buffer + u_resident)


def backward_plan(
    batch: int, hidden: int, bf16: bool, *, sms: int, smem_optin: int, smem_per_sm: int
) -> BackwardPlan:
    """The first plan, U resident before streamed and fewest groups first, whose
    grid (both directions) is resident on ``sms`` SMs at once; raises if none is."""
    if not 1 <= batch <= BWD_ROWS * BWD_MAX_GROUPS or not 1 <= hidden <= BWD_MAX_HIDDEN:
        raise ValueError(
            f"lstm_train_backward: B={batch}, H={hidden} outside B in [1, "
            f"{BWD_ROWS * BWD_MAX_GROUPS}], H in [1, {BWD_MAX_HIDDEN}]"
        )
    unit_blocks = -(-hidden // BWD_UNITS)
    row_groups = -(-batch // BWD_ROWS)
    found = resident_tiling(
        bf16, lambda resident: backward_smem_bytes(hidden, bf16, resident),
        lambda groups: 2 * -(-row_groups // groups) * unit_blocks,
        sms=sms, smem_optin=smem_optin, smem_per_sm=smem_per_sm,
        blocks_per_sm=BWD_BLOCKS_PER_SM, max_groups=BWD_MAX_GROUPS,
    )
    if found is None:
        raise ValueError(
            f"lstm_train_backward: no resident grid for B={batch}, H={hidden} on {sms} SMs "
            f"with {smem_optin} bytes of shared memory a block"
        )
    resident, smem, per_sm, groups = found
    return BackwardPlan(groups, resident, smem, unit_blocks, -(-row_groups // groups), per_sm)


def _scan_times(steps: int, s: int) -> list[int]:
    """Real time index of scan step ``s`` for each direction."""
    return [steps - 1 - s if r else s for r in BIDIRECTIONAL]


def _check_keep(keep: torch.Tensor | None, batch: int, steps: int):
    if keep is not None and tuple(keep.shape) != (2, batch, steps):
        raise ValueError(f"keep {tuple(keep.shape)} is not [2, B, T] = {(2, batch, steps)}")


def _launch_checks(name: str, first: torch.Tensor, *others: torch.Tensor | None, dtype):
    if first.device.type != "cuda" or any(
        o is not None and o.device != first.device for o in others
    ):
        devices = [str(first.device), *(str(o.device) for o in others if o is not None)]
        raise ValueError(f"{name}: tensors on {devices}")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: compute dtype {dtype} not in {_KERNEL_DTYPES}")


def lstm_train_forward_plain(
    xw: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lstm_train_forward`, on any device."""
    hidden = _check_shapes(xw, recurrent, BIDIRECTIONAL)
    dtype = compute_dtype or xw.dtype
    dirs, batch, steps, four_h = xw.shape
    _check_keep(keep, batch, steps)
    xw32 = xw.to(dtype).to(torch.float32)
    u32 = recurrent.to(dtype).to(torch.float32)
    h = xw32.new_zeros((dirs, batch, hidden))
    c = xw32.new_zeros((dirs, batch, hidden))
    out = torch.empty((batch, steps, dirs * hidden), dtype=dtype, device=xw.device)
    gates = torch.empty((dirs, batch, steps, four_h), dtype=dtype, device=xw.device)
    c_all = torch.empty((dirs, batch, steps, hidden), dtype=torch.float32, device=xw.device)
    for s in range(steps):
        times = _scan_times(steps, s)
        if keep is not None:
            k = keep[:, :, s, None].to(torch.float32)
            h, c = h * k, c * k
        x_t = torch.stack([xw32[d, :, t] for d, t in enumerate(times)])
        z = x_t + torch.bmm(h.to(dtype).to(torch.float32), u32)
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        i, f, g, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)
        c = f * c + i * g
        h = o * torch.tanh(c)
        g4 = torch.cat([i, f, g, o], dim=-1).to(dtype)
        for d, t in enumerate(times):
            out[:, t, d * hidden : (d + 1) * hidden] = h[d].to(dtype)
            gates[d, :, t] = g4[d]
            c_all[d, :, t] = c[d]
    return out, gates, c_all


def lstm_train_forward(
    xw: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence of both directions (``D = 2``, direction 1 backwards in
    time) with its training residuals.

    ``xw``: ``[D, B, T, 4H]`` input projections at real time;
    ``recurrent``: ``[D, H, 4H]``; ``keep``: optional ``[D, B, T]`` carry gate
    in scan order. Returns ``(out [B, T, D * H], gates [D, B, T, 4H])`` in the
    compute dtype (default ``xw.dtype``) and ``c_all [D, B, T, H]`` in fp32.
    """
    if use_plain(xw):
        return lstm_train_forward_plain(xw, recurrent, keep=keep, compute_dtype=compute_dtype)
    dtype = compute_dtype or xw.dtype
    _launch_checks("lstm_train_forward", xw, recurrent, keep, dtype=dtype)
    hidden = _check_shapes(xw, recurrent, BIDIRECTIONAL)
    dirs, batch, steps, four_h = xw.shape
    _check_keep(keep, batch, steps)
    xw = xw.to(dtype).contiguous()
    recurrent = recurrent.to(dtype).contiguous()
    if keep is not None:
        keep = keep.to(torch.float32).contiguous()
    out = torch.empty((batch, steps, dirs * hidden), dtype=dtype, device=xw.device)
    gates = torch.empty((dirs, batch, steps, four_h), dtype=dtype, device=xw.device)
    c_all = torch.empty((dirs, batch, steps, hidden), dtype=torch.float32, device=xw.device)
    if steps == 0 or batch == 0:
        return out, gates, c_all
    plan = forward_plan(batch, hidden, dtype == torch.bfloat16, dirs, **_device_limits(xw.device))
    _forward_launch(lstm_train_forward, xw, recurrent, out, REVERSE_MASK, plan,
                    gates=gates, c_all=c_all, keep=keep)
    return out, gates, c_all


lstm_train_forward.launches = 0
lstm_train_forward.keep_launches = 0  # the launches of those with a carry gate


def lstm_train_backward_plain(
    gates: torch.Tensor,
    c_all: torch.Tensor,
    dy: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Plain version of :func:`lstm_train_backward`, on any device."""
    dtype = compute_dtype or gates.dtype
    dirs, batch, steps, four_h = gates.shape
    hidden = four_h // 4
    _check_keep(keep, batch, steps)
    u_t = recurrent.to(dtype).to(torch.float32).transpose(1, 2)  # [D, 4H, H]
    dy32 = dy.to(dtype).to(torch.float32)
    dgates = torch.empty((dirs, batch, steps, four_h), dtype=dtype, device=gates.device)
    dh = dy32.new_zeros((dirs, batch, hidden))
    dc = dy32.new_zeros((dirs, batch, hidden))
    for s in reversed(range(steps)):
        times = _scan_times(steps, s)
        g4 = torch.stack([gates[d, :, t] for d, t in enumerate(times)]).to(torch.float32)
        i, f, g, o = g4.split(hidden, dim=-1)
        c = torch.stack([c_all[d, :, t] for d, t in enumerate(times)])
        if s > 0:
            before = _scan_times(steps, s - 1)
            c_prev = torch.stack([c_all[d, :, t] for d, t in enumerate(before)])
        else:
            c_prev = torch.zeros_like(c)
        if keep is not None:
            k = keep[:, :, s, None].to(torch.float32)
            c_prev = c_prev * k  # the forward consumed keep[s]·c_{s-1}
        th = torch.tanh(c)
        dh_tot = (
            torch.stack([dy32[:, t, d * hidden : (d + 1) * hidden] for d, t in enumerate(times)])
            + dh
        )
        do = dh_tot * th * o * (1.0 - o)
        dc = dc + dh_tot * o * (1.0 - th * th)
        di = dc * g * i * (1.0 - i)
        df = dc * c_prev * f * (1.0 - f)
        dg = dc * i * (1.0 - g * g)
        dgt = torch.cat([di, df, dg, do], dim=-1).to(dtype)
        for d, t in enumerate(times):
            dgates[d, :, t] = dgt[d]
        dh = torch.bmm(dgt.to(torch.float32), u_t)
        dc = dc * f
        if keep is not None:
            dh, dc = dh * k, dc * k
    return dgates


def lstm_train_backward(
    gates: torch.Tensor,
    c_all: torch.Tensor,
    dy: torch.Tensor,
    recurrent: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Pre-activation gate gradients ``dgates [D, B, T, 4H]`` (compute dtype).

    ``gates``, ``c_all``: the residuals of :func:`lstm_train_forward`;
    ``dy``: ``[B, T, D * H]``, the gradient of its ``out``; ``recurrent`` and
    ``keep`` as given to the forward.
    """
    if use_plain(gates):
        return lstm_train_backward_plain(
            gates, c_all, dy, recurrent, keep=keep, compute_dtype=compute_dtype
        )
    dtype = compute_dtype or gates.dtype
    _launch_checks("lstm_train_backward", gates, c_all, dy, recurrent, keep, dtype=dtype)
    dirs, batch, steps, four_h = gates.shape
    hidden = four_h // 4
    if (
        tuple(c_all.shape) != (dirs, batch, steps, hidden)
        or tuple(dy.shape) != (batch, steps, dirs * hidden)
        or tuple(recurrent.shape) != (dirs, hidden, four_h)
        or dirs != 2
    ):
        raise ValueError(
            f"lstm_train_backward: gates {tuple(gates.shape)}, c_all {tuple(c_all.shape)}, "
            f"dy {tuple(dy.shape)}, recurrent {tuple(recurrent.shape)}"
        )
    _check_keep(keep, batch, steps)
    gates = gates.to(dtype).contiguous()
    c_all = c_all.to(torch.float32).contiguous()
    dy = dy.to(dtype).contiguous()
    recurrent = recurrent.to(dtype).contiguous()
    if keep is not None:
        keep = keep.to(torch.float32).contiguous()
    dgates = torch.empty((dirs, batch, steps, four_h), dtype=dtype, device=gates.device)
    if steps == 0 or batch == 0:
        return dgates
    limits = _device_limits(gates.device)
    for row0, rows in row_slices(batch):
        whole = rows == batch
        part = slice(row0, row0 + rows)
        out = dgates if whole else torch.empty_like(dgates[:, part])
        _backward_launch(
            gates[:, part].contiguous(), c_all[:, part].contiguous(), dy[part], recurrent,
            None if keep is None else keep[:, part].contiguous(), out,
            backward_plan(rows, hidden, dtype == torch.bfloat16, **limits),
        )
        if not whole:
            dgates[:, part] = out
    return dgates


def _backward_launch(gates, c_all, dy, recurrent, keep, dgates, plan: BackwardPlan) -> None:
    """One cooperative launch of the backward kernel on prepared tensors;
    raises if the card refuses it (a grid that cannot be resident at once)."""
    dirs, batch, steps, four_h = gates.shape
    counters = torch.zeros((dirs, plan.row_blocks), dtype=torch.int32, device=gates.device)
    with torch.cuda.device(gates.device):
        code = _build.library().sst_lstm_train_backward(
            gates.data_ptr(), c_all.data_ptr(), dy.data_ptr(), recurrent.data_ptr(),
            None if keep is None else keep.data_ptr(), dgates.data_ptr(), counters.data_ptr(),
            dirs, batch, steps, four_h // 4, REVERSE_MASK, int(gates.dtype == torch.bfloat16),
            plan.groups, int(plan.resident), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "lstm_train_backward")
    lstm_train_backward.launches += 1
    if keep is not None:
        lstm_train_backward.keep_launches += 1


lstm_train_backward.launches = 0
lstm_train_backward.keep_launches = 0  # the launches of those with a carry gate


def _input_projection(x, kernel, bias, dtype):
    """``[2, B, T, 4H]``: ``bf16(x @ W)`` to fp32, plus the bias, to the compute dtype."""
    xw = torch.matmul(x.to(dtype).unsqueeze(0), kernel.to(dtype).unsqueeze(1))
    return (xw.to(torch.float32) + bias.to(torch.float32)[:, None, None, :]).to(dtype)


def _previous_states(y: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
    """``[2, B, T, H]`` fp32: the hidden state each direction consumed at
    each time step (zero at its first step, gated by keep)."""
    h0, h1 = y.to(torch.float32).chunk(2, dim=-1)
    zero = torch.zeros_like(h0[:, :1])
    hp0 = torch.cat([zero, h0[:, :-1]], dim=1)  # forwards: the state of t - 1
    hp1 = torch.cat([h1[:, 1:], zero], dim=1)  # backwards: the state of t + 1
    if keep is not None:
        hp0 = hp0 * keep[0, :, :, None]
        hp1 = hp1 * keep[1].flip(-1)[:, :, None]  # scan step T - 1 - t
    return torch.stack([hp0, hp1])


class _BiLSTMTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, recurrent, bias, keep, dtype):
        xw = _input_projection(x, kernel, bias, dtype)
        y, gates, c_all = lstm_train_forward(xw, recurrent, keep=keep, compute_dtype=dtype)
        ctx.save_for_backward(x, kernel, recurrent, y, gates, c_all, keep)
        # the backward may run on autograd's own thread, outside the caller's switch
        ctx.dtype, ctx.plain, ctx.bias_dtype = dtype, use_plain(xw), bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, kernel, recurrent, y, gates, c_all, keep = ctx.saved_tensors
        run = lstm_train_backward_plain if ctx.plain else lstm_train_backward
        dgates = run(gates, c_all, dy, recurrent, keep=keep, compute_dtype=ctx.dtype)
        dxw = dgates.to(torch.float32)  # [2, B, T, 4H]
        dkernel = torch.einsum("btf,dbtg->dfg", x.to(torch.float32), dxw)
        dbias = dxw.sum(dim=(1, 2))
        dx = torch.einsum("dbtg,dfg->btf", dxw, kernel.to(torch.float32))
        drec = torch.einsum("dbth,dbtg->dhg", _previous_states(y, keep), dxw)
        return (
            dx.to(x.dtype), dkernel.to(kernel.dtype), drec.to(recurrent.dtype),
            dbias.to(ctx.bias_dtype), None, None,
        )


def bilstm_train(
    x: torch.Tensor,
    kernel: torch.Tensor,
    recurrent: torch.Tensor,
    bias: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Differentiable BiLSTM layer: ``x [B, T, F]`` → ``[B, T, 2H]`` in ``compute_dtype``.

    ``kernel [2, F, 4H]``, ``recurrent [2, H, 4H]``, ``bias [2, 4H]``: the
    parameter layout of ``bilstm_train_pallas``. ``keep [2, B, T]``: optional
    carry gate, each direction in its own scan order (``keep`` gets no
    gradient). Both recurrences run their plain loops where
    ``dispatch.use_plain`` says.
    """
    return _BiLSTMTrain.apply(x, kernel, recurrent, bias, keep, compute_dtype)


def bilstm_reference(
    x: torch.Tensor,
    kernel: torch.Tensor,
    recurrent: torch.Tensor,
    bias: torch.Tensor,
    *,
    keep: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`bilstm_train` in fp32 by autograd through a plain loop (no
    custom backward): the reference its gradients are held against."""
    batch, steps, _ = x.shape
    hidden = recurrent.shape[1]
    xs = torch.stack([x, x.flip(1)])  # each direction in its scan order
    xw = torch.einsum("dbtf,dfg->dbtg", xs, kernel) + bias[:, None, None, :]
    h = x.new_zeros((2, batch, hidden))
    c = x.new_zeros((2, batch, hidden))
    hs = []
    for s in range(steps):
        if keep is not None:
            k = keep[:, :, s, None]
            h, c = h * k, c * k
        z = xw[:, :, s] + torch.bmm(h, recurrent)
        zi, zf, zg, zo = z.split(hidden, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        h = torch.sigmoid(zo) * torch.tanh(c)
        hs.append(h)
    h_all = torch.stack(hs, dim=2)  # [2, B, T, H] in scan order
    return torch.cat([h_all[0], h_all[1].flip(1)], dim=-1)
