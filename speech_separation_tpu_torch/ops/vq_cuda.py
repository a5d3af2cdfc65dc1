"""Nearest-codebook search kernel (counterpart of ``ops/vq_pallas.py``).

:func:`nearest_code` runs ``csrc/nearest_code.cu``: for each row of ``flat``
the index of the nearest codebook column, the argmin over K of ``‖e‖² −
2·x·e`` in fp32 FMA (no TF32), with no ``[N, K]`` matrix in device memory;
exact ties go to the lowest index. Two forms, one kernel:

- ``flat [N, D]``, ``codebook [D, K]`` → int32 ``[N]``;
- grouped: ``flat [N, G·S]``, ``codebook [G, S, K]`` → int32 ``[N, G]``, group
  ``g`` searching columns ``g·S .. (g+1)·S − 1`` against ``codebook[g]`` (one
  residual-VQ stage's product-quantisation groups in one launch).

``flat`` may have any row stride as long as its columns are contiguous. The
kernel is one persistent launch laid out by :func:`search_plan` from the
card's SM count and shared memory: 16-row units dealt to the CTAs as
contiguous ranges, every group's codebook resident in shared memory (a unit
then covers its rows in every group), or, where they do not fit, a unit's
group streamed through a double-buffered ring.

Its plain version, :func:`nearest_code_plain`, computes the same formula with
one matmul and ``torch.argmin`` a group; the wrapper takes it where
``dispatch.use_plain`` says (a CPU tensor, or inside ``plain_versions()``),
and otherwise launches the kernel or raises. Both return
int32 indices, the dtype of the JAX function. The search drops ``‖x‖²``,
constant per row, as the Pallas kernel does; the JAX package's XLA branch
keeps it, which can only matter at near ties.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .dispatch import use_plain
from .tcn_cuda import _device_limits

__all__ = [
    "MAX_DIM",
    "SEARCH_CHUNK_CODES",
    "SEARCH_STREAM_DIMS",
    "SEARCH_CODE_WARPS",
    "SEARCH_STEP_ROWS",
    "SEARCH_THREADS",
    "SEARCH_TILE_ROWS",
    "SearchPlan",
    "nearest_code",
    "nearest_code_plain",
    "search_plan",
    "search_smem_bytes",
]

SEARCH_THREADS = 256  # 8 warps a CTA
SEARCH_CHUNK_CODES = 512  # codes a chunk
SEARCH_STREAM_DIMS = 32  # dims a streamed codebook block
# csrc/nearest_code.cu's register tile (tests hold it to the source): 8 rows by
# 8 codes a thread, a warp 4 lanes along rows by 8 along codes, so the 8 warps
# all lie along a chunk's 512 codes and a full step covers 32 rows, two work
# units (a lone unit runs at 4 rows a thread). 64 accumulators a thread leave
# room for one CTA an SM.
SEARCH_CODE_WARPS = 8
SEARCH_STEP_ROWS = 32
SEARCH_TILE_ROWS = SEARCH_STEP_ROWS // 2  # rows a work unit
_MAX_CTAS_PER_SM = 1  # the kernel's __launch_bounds__ minimum
MAX_DIM = 256
_RESERVED_BYTES = 1024  # the system's shared memory a CTA


def _segment(dim: int) -> int:
    """A group's columns in a staged row: ``dim`` rounded to 4 (16-byte aligned)."""
    return -(-dim // 4) * 4


def _row_stride(dim: int, groups: int) -> int:
    """A staged row of ``groups`` segments, then to an odd multiple of 4
    floats, so a warp's row groups hit distinct bank groups."""
    width = groups * _segment(dim)
    return width + 4 if width // 4 % 2 == 0 else width


def _pad_codes(codes: int) -> int:
    return -(-codes // SEARCH_CHUNK_CODES) * SEARCH_CHUNK_CODES


def search_smem_bytes(dim: int, codes: int, groups: int, resident: bool) -> int:
    """Dynamic shared memory of a CTA: every group's codebook ``[S][Kpad]``
    (resident) or the ring's two ``[32][512]`` blocks, two row stages ``[step
    rows][row stride]`` of the step's groups (all, resident; one, streamed),
    ‖e‖² of the resident codes or one chunk, the merge's (score, index) a
    step group, warp along codes and step row."""
    kpad = _pad_codes(codes)
    step_groups = groups if resident else 1
    book = groups * dim * kpad if resident else 2 * SEARCH_STREAM_DIMS * SEARCH_CHUNK_CODES
    norms = groups * kpad if resident else SEARCH_CHUNK_CODES
    rows = SEARCH_STEP_ROWS
    return (4 * (book + 2 * rows * _row_stride(dim, step_groups) + norms)
            + 8 * step_groups * SEARCH_CODE_WARPS * rows)


@dataclasses.dataclass(frozen=True)
class SearchPlan:
    """One launch of ``ctas`` CTAs over ``units`` work units: resident, a
    unit is a row tile of every group (``tiles`` units); streamed, a (group,
    row tile), group-major (``groups × tiles``). CTA ``c`` owns the
    contiguous units :meth:`owned` and walks them two at a time within a
    group (a full step), one where a group or its range ends."""

    resident: bool  # every group's codebook held in shared memory, else streamed
    smem: int  # dynamic shared memory a CTA
    ctas_per_sm: int
    ctas: int
    tiles: int  # row tiles a group
    units: int

    def owned(self, cta: int) -> range:
        """The units CTA ``cta`` walks: ``q`` or ``q + 1`` of them, the first
        ``r`` CTAs taking one more (``q, r = divmod(units, ctas)``)."""
        q, r = divmod(self.units, self.ctas)
        start = cta * q + min(cta, r)
        return range(start, start + q + (cta < r))


def search_plan(rows: int, groups: int, dim: int, codes: int, *, sms: int, smem_optin: int,
                smem_per_sm: int) -> SearchPlan:
    """The search's launch plan on a card with ``sms`` SMs and ``smem_optin``
    bytes of shared memory a block, ``smem_per_sm`` an SM: resident where
    every group's padded codebook and the row stages fit a block, streamed
    otherwise; as many CTAs an SM as fit (at most the kernel's one), at most
    one a unit. Raises on shapes the kernel does not take."""
    if rows < 0 or groups < 1 or not 1 <= dim <= MAX_DIM or codes < 1:
        raise ValueError(f"nearest_code: needs N >= 0, G >= 1, 1 <= D <= {MAX_DIM} and K >= 1, "
                         f"got N={rows}, G={groups}, D={dim}, K={codes}")
    resident = True
    smem = search_smem_bytes(dim, codes, groups, True)
    if smem > smem_optin or smem + _RESERVED_BYTES > smem_per_sm:
        resident, smem = False, search_smem_bytes(dim, codes, groups, False)
        if smem > smem_optin or smem + _RESERVED_BYTES > smem_per_sm:
            raise ValueError(f"nearest_code: {smem} bytes of shared memory a CTA; the card has "
                             f"{smem_optin} a block")
    per_sm = min(_MAX_CTAS_PER_SM, smem_per_sm // (smem + _RESERVED_BYTES))
    tiles = -(-rows // SEARCH_TILE_ROWS)
    units = tiles * (1 if resident else groups)
    return SearchPlan(resident, smem, per_sm, min(units, sms * per_sm), tiles, units)


def _split(flat: torch.Tensor, codebook: torch.Tensor) -> tuple[int, int, int, int]:
    """``(N, G, S, K)`` of a 2-D or grouped call; raises on other shapes."""
    if flat.dim() == 2 and codebook.dim() == 2 and codebook.shape[0] == flat.shape[1]:
        return flat.shape[0], 1, codebook.shape[0], codebook.shape[1]
    if (flat.dim() == 2 and codebook.dim() == 3
            and codebook.shape[0] * codebook.shape[1] == flat.shape[1]):
        return flat.shape[0], *codebook.shape
    raise ValueError(f"nearest_code: expected flat [N, D] and codebook [D, K], or flat [N, G*S] "
                     f"and codebook [G, S, K], got {tuple(flat.shape)} and {tuple(codebook.shape)}")


def nearest_code_plain(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``argmin_k (‖e_k‖² − 2·flat_n·e_k)`` as int32: the kernel's formula, one
    matmul a group. ``[N]`` for ``codebook [D, K]``, ``[N, G]`` for
    ``codebook [G, S, K]``."""
    if codebook.dim() == 2:
        scores = (codebook * codebook).sum(0) - 2.0 * (flat @ codebook)
        return torch.argmin(scores, dim=1).to(torch.int32)
    _split(flat, codebook)
    sub = codebook.shape[1]
    return torch.stack([nearest_code_plain(flat[:, g * sub : (g + 1) * sub], codebook[g])
                        for g in range(codebook.shape[0])], dim=1)


def nearest_code(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest codebook column for each row (and group): ``flat
    [N, D]``, ``codebook [D, K]`` → int32 ``[N]``; ``flat [N, G·S]``,
    ``codebook [G, S, K]`` → int32 ``[N, G]``. fp32; ``flat``'s columns
    contiguous, ``codebook`` contiguous."""
    if use_plain(flat):
        return nearest_code_plain(flat, codebook)
    if flat.device.type != "cuda" or codebook.device != flat.device:
        raise ValueError(f"nearest_code: unsupported devices {flat.device}, {codebook.device}")
    rows, groups, dim, codes = _split(flat, codebook)
    if flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"nearest_code: expected float32, got {flat.dtype} and {codebook.dtype}")
    width = groups * dim
    ld = flat.stride(0) if rows > 1 else width
    if not codebook.is_contiguous() or (width > 1 and flat.stride(1) != 1) or ld < width:
        raise ValueError(f"nearest_code: the codebook must be contiguous and flat's columns "
                         f"contiguous, got strides {flat.stride()} and {codebook.stride()}")
    if not 1 <= dim <= MAX_DIM or codes < 1:
        raise ValueError(f"nearest_code: needs 1 <= D <= {MAX_DIM} and K >= 1, got D={dim}, "
                         f"K={codes}")
    out = torch.empty((rows,) if codebook.dim() == 2 else (rows, groups), dtype=torch.int32,
                      device=flat.device)
    if rows == 0:
        return out
    limits = _device_limits(flat.device)
    plan = search_plan(rows, groups, dim, codes, sms=limits["sms"],
                       smem_optin=limits["smem_optin"], smem_per_sm=limits["smem_per_sm"])
    with torch.cuda.device(flat.device):
        code = _build.library().sst_nearest_code(
            flat.data_ptr(), codebook.data_ptr(), out.data_ptr(), rows, ld, groups, dim, codes,
            plan.ctas, int(plan.resident), plan.smem, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, "nearest_code")
    nearest_code.launches += 1
    return out


nearest_code.launches = 0
