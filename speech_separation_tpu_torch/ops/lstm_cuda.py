"""LSTM recurrence kernel (counterpart of ``ops/lstm_pallas.py``).

:func:`lstm_recurrence` runs the recurrence of one or both directions of an
(Bi)LSTM layer over precomputed input projections ``xw = x @ W + b``, in
``csrc/lstm_recurrence.cu``: one persistent cooperative launch over all time
steps, tiled by :func:`forward_plan` (one launch per row slice where the
batch is above 256 rows). :func:`lstm_recurrence_plain` is its plain PyTorch
version (a Python loop over time), which the wrapper takes only for a tensor
on the CPU; on a CUDA tensor it launches the kernel or raises. The training
forward (``ops/lstm_train_cuda.py``) shares the plan and the launch.

Semantics follow ``lstm_pallas``: Keras gate order i, f, g, o; the (h, c)
carry in fp32; operands (xw, U and h before each product) in the compute
dtype, fp32 or bf16, with fp32 accumulation; outputs in the compute dtype. A
reversed direction walks time backwards over the full padded length and
writes each output at its own time index, which equals the JAX BiLSTM's
flip, scan, flip back.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import torch

from .. import _build

__all__ = [
    "ForwardPlan",
    "forward_plan",
    "forward_smem_bytes",
    "resident_tiling",
    "row_slices",
    "lstm_recurrence",
    "lstm_recurrence_plain",
]

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)

# The forward kernel's tiling (csrc/lstm_recurrence.cu): a block owns 16
# hidden units of one direction (their four gate columns, 64 columns of U) for
# `groups` groups of 16 batch rows, multiplied `pass_groups` at a time (fp32
# one, bf16 up to eight, a warp each); 256 threads, one block an SM (the fp32
# lane tile needs more than 128 registers). A launch takes at most 16 groups
# a block in one row block, so 256 rows; a larger batch is cut into row
# slices, one launch each. With 16 units a block every H <= 1024 fits 132 SMs
# in both directions (2 x 64 unit slices).
FWD_ROWS, FWD_UNITS, FWD_MAX_GROUPS = 16, 16, 16
FWD_MAX_ROWS = FWD_ROWS * FWD_MAX_GROUPS
FWD_MAX_HIDDEN = 1024
FWD_MAX_PASS = {False: 2, True: 8}  # by bf16
FWD_BLOCKS_PER_SM = 1
FWD_PARTIAL_BYTES = 8 * FWD_ROWS * 4 * FWD_UNITS * 4  # 8 warps' fp32 partial sums
RESERVED_BYTES = 1024  # shared memory the card keeps back for each block


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """Launch plan of the persistent forward kernel (serving and training)."""

    groups: int  # groups of 16 rows a block owns
    pass_groups: int  # groups multiplied together (a power of two)
    resident: bool  # U's slice stays in shared memory (else read through L1 from L2)
    smem: int  # dynamic shared memory a block, bytes (the kernel sizes its own)
    unit_blocks: int
    row_blocks: int  # of the largest row slice
    blocks_per_sm: int  # how many fit an SM by shared memory and registers
    dirs: int
    slices: tuple[tuple[int, int], ...]  # (first row, rows) of each launch

    @property
    def blocks(self) -> int:
        return self.dirs * self.row_blocks * self.unit_blocks


def forward_smem_bytes(hidden: int, bf16: bool, resident: bool, pass_groups: int = 1) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out
    (``smem_bytes`` in the .cu file): the warps' partial sums, h_{s-1} of a
    pass's groups and, if resident, U's slice transposed: 16 rows a group and
    64 rows of the depth padded to 16, plus 8."""
    depth = -(-hidden // 16) * 16
    rows = FWD_ROWS * pass_groups + (4 * FWD_UNITS if resident else 0)
    return FWD_PARTIAL_BYTES + (2 if bf16 else 4) * rows * (depth + 8)


def row_slices(batch: int) -> tuple[tuple[int, int], ...]:
    """(first row, rows) of each launch: as few slices of at most 256 rows as
    cover ``batch``, of equal size in whole groups of 16 but the last."""
    count = -(-batch // FWD_MAX_ROWS)
    size = -(-(-(-batch // count)) // FWD_ROWS) * FWD_ROWS
    return tuple((start, min(size, batch - start)) for start in range(0, batch, size))


def resident_tiling(
    bf16: bool, smem_of, blocks_of, *, sms: int, smem_optin: int, smem_per_sm: int,
    blocks_per_sm: int = 1, max_groups: int = 16,
) -> tuple[bool, int, int, int] | None:
    """The tiling search the persistent LSTM kernels share: the first
    ``(resident, smem, per_sm, groups)``, U resident before streamed (bf16
    always resident) and fewest groups a block first, whose grid of
    ``blocks_of(groups)`` blocks, each taking ``smem_of(resident)`` bytes of
    shared memory, is resident on ``sms`` SMs at once; None if none is."""
    for resident in (True,) if bf16 else (True, False):
        smem = smem_of(resident)
        per_sm = min(blocks_per_sm, smem_per_sm // (smem + RESERVED_BYTES))
        if smem > smem_optin or per_sm < 1:
            continue
        for groups in range(1, max_groups + 1):
            if blocks_of(groups) <= sms * per_sm:
                return resident, smem, per_sm, groups
    return None


def forward_plan(
    batch: int, hidden: int, bf16: bool, dirs: int, *, sms: int, smem_optin: int, smem_per_sm: int
) -> ForwardPlan:
    """The first plan, U resident before streamed and fewest groups first, whose
    grid (``dirs`` directions, the largest row slice) is resident on ``sms``
    SMs at once, with as many groups a pass as fit; raises if none is."""
    if batch < 1 or not 1 <= hidden <= FWD_MAX_HIDDEN or dirs not in (1, 2):
        raise ValueError(
            f"lstm forward: B={batch}, H={hidden}, D={dirs} outside B >= 1, H in [1, "
            f"{FWD_MAX_HIDDEN}], D in (1, 2)"
        )
    slices = row_slices(batch)
    unit_blocks = -(-hidden // FWD_UNITS)
    row_groups = -(-slices[0][1] // FWD_ROWS)
    found = resident_tiling(
        bf16, lambda resident: forward_smem_bytes(hidden, bf16, resident),
        lambda groups: dirs * -(-row_groups // groups) * unit_blocks,
        sms=sms, smem_optin=smem_optin, smem_per_sm=smem_per_sm,
        blocks_per_sm=FWD_BLOCKS_PER_SM, max_groups=FWD_MAX_GROUPS,
    )
    if found is None:
        raise ValueError(
            f"lstm forward: no resident grid for B={batch}, H={hidden}, D={dirs} on {sms} SMs "
            f"with {smem_optin} bytes of shared memory a block"
        )
    resident, _, per_sm, groups = found
    passes = 1
    while passes * 2 <= min(groups, FWD_MAX_PASS[bf16]):
        wider = forward_smem_bytes(hidden, bf16, resident, passes * 2)
        if wider > smem_optin or per_sm * (wider + RESERVED_BYTES) > smem_per_sm:
            break
        passes *= 2
    return ForwardPlan(groups, passes, resident, forward_smem_bytes(hidden, bf16, resident, passes),
                       unit_blocks, -(-row_groups // groups), per_sm, dirs, slices)


@functools.lru_cache(maxsize=8)
def _device_limits(device: torch.device) -> dict:
    props = torch.cuda.get_device_properties(device)
    return {
        "sms": props.multi_processor_count,
        "smem_optin": props.shared_memory_per_block_optin,
        "smem_per_sm": props.shared_memory_per_multiprocessor,
    }


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
    out = torch.empty((batch, steps, dirs * hidden), dtype=dtype, device=xw.device)
    if steps == 0 or batch == 0:
        return out
    reverse_mask = sum(1 << d for d, r in enumerate(reverse) if r)
    plan = forward_plan(batch, hidden, dtype == torch.bfloat16, dirs, **_device_limits(xw.device))
    _forward_launch(lstm_recurrence, xw, recurrent, out, reverse_mask, plan)
    return out


def _forward_launch(
    wrapper, xw, recurrent, out, reverse_mask: int, plan: ForwardPlan, *,
    gates=None, c_all=None, keep=None,
) -> None:
    """The forward kernel on prepared tensors, one cooperative launch per row
    slice of ``plan``, each counted on ``wrapper.launches`` (and, with a carry
    gate, on ``wrapper.keep_launches``): the serving entry, or the training
    one when ``gates`` and ``c_all`` are given. Raises if the
    card refuses a launch (a grid that cannot be resident at once)."""
    dirs, batch, steps, four_h = xw.shape
    counters = torch.zeros((len(plan.slices), dirs, plan.row_blocks), dtype=torch.int32,
                           device=xw.device)
    bf16 = int(xw.dtype == torch.bfloat16)
    with torch.cuda.device(xw.device):
        lib, stream = _build.library(), torch.cuda.current_stream().cuda_stream
        for i, (row0, rows) in enumerate(plan.slices):
            shape = (dirs, batch, row0, rows, steps, four_h // 4, reverse_mask, bf16,
                     plan.groups, plan.pass_groups, int(plan.resident), stream)
            if gates is None:
                code = lib.sst_lstm_recurrence(
                    xw.data_ptr(), recurrent.data_ptr(), out.data_ptr(), counters[i].data_ptr(),
                    *shape,
                )
            else:
                code = lib.sst_lstm_train_forward(
                    xw.data_ptr(), recurrent.data_ptr(), out.data_ptr(), gates.data_ptr(),
                    c_all.data_ptr(), None if keep is None else keep.data_ptr(),
                    counters[i].data_ptr(), *shape,
                )
            _build.check(code, wrapper.__name__)
            wrapper.launches += 1
            if keep is not None:
                wrapper.keep_launches += 1


lstm_recurrence.launches = 0
