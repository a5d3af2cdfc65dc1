"""PyTorch port: the launch plan of the persistent LSTM forward kernel, on the CPU.

``ops/lstm_cuda.py::forward_plan`` tiles ``csrc/lstm_recurrence.cu``'s
cooperative launches (serving and training forward) from the card's SM count
and shared memory, and cuts a batch above what one resident grid holds at 16
row groups a block (``launch_rows``) into row slices, one launch each. A plan
is right when every (direction, batch row, hidden unit) is owned
by exactly one thread of one block of one launch, when a block's shared memory
fits the card's opt-in limit, and when each launch's grid fits the card at
once (a cooperative launch that cannot is refused). These tests check that
arithmetic with an H100's figures, and that the ctypes signatures match the C
entry points; the kernel itself runs in ``test_torch_cuda.py`` on a GPU.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.ops.lstm_cuda import (
    FWD_BLOCKS_PER_SM,
    FWD_MAX_GROUPS,
    FWD_MAX_PASS,
    FWD_MAX_ROWS,
    FWD_ROWS,
    FWD_UNITS,
    FWD_X_STRIDE,
    ForwardPlan,
    forward_plan,
    forward_smem_bytes,
    launch_rows,
    resident_tiling,
    row_slices,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an SM
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472}
THREADS = 256
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
# (B, H): ragged shapes, the CLI's batch, the training bench's, two row
# blocks, the serving bench's, the widest hidden size, one launch above 256
# rows, row slices, and DPRNN's dual-path rows at H = 128 (a 16 x 2 s
# batch's intra rows, a 16 x 10 s batch's inter rows, a ragged last launch,
# a 16 x 10 s batch's intra rows)
SHAPES = [(3, 20), (33, 40), (4, 496), (32, 496), (64, 496), (256, 496), (1, 1024),
          (256, 1024), (300, 496), (1000, 1024), (2064, 128), (4000, 128), (4112, 128),
          (10256, 128)]


def _owners(plan, batch, hidden):
    """How many threads own each (direction, row, unit), walking every launch's
    grid as the kernel does: block (unit slice, row block, direction), group g,
    thread (row, unit) = (tid / 16, tid % 16), rows counted from the slice's first."""
    count = np.zeros((plan.dirs, batch, hidden), dtype=np.int64)
    tid = np.arange(THREADS)
    for row0, rows in plan.slices:
        row_blocks = -(-rows // (plan.groups * FWD_ROWS))
        for d in range(plan.dirs):
            for rb in range(row_blocks):
                for us in range(plan.unit_blocks):
                    for g in range(plan.groups):
                        b0 = (rb * plan.groups + g) * FWD_ROWS
                        if b0 >= rows:
                            break
                        b, j = b0 + tid // FWD_UNITS, us * FWD_UNITS + tid % FWD_UNITS
                        ok = (b < rows) & (j < hidden)
                        np.add.at(count[d], (row0 + b[ok], j[ok]), 1)
    return count


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_every_row_and_unit_is_owned_once(batch, hidden, bf16, dirs):
    plan = forward_plan(batch, hidden, bf16, dirs, **H100)
    assert (_owners(plan, batch, hidden) == 1).all()


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_plan_fits_the_card(batch, hidden, bf16, dirs):
    plan = forward_plan(batch, hidden, bf16, dirs, **H100)
    assert plan.smem <= H100["smem_optin"]
    # a power of two, at most the groups a block owns and the type's limit
    assert plan.pass_groups & (plan.pass_groups - 1) == 0
    assert 1 <= plan.pass_groups <= min(plan.groups, FWD_MAX_PASS[bf16])
    assert plan.blocks_per_sm * (plan.smem + 1024) <= H100["smem_per_sm"]
    assert plan.unit_blocks * FWD_UNITS >= hidden
    # the copies run ahead only where the kernel has that instantiation and
    # a block walks more than one pass a step
    assert not plan.ahead or (plan.resident and 2 <= plan.pass_groups < plan.groups
                              and hidden % (8 if bf16 else 4) == 0)
    assert plan.smem == forward_smem_bytes(hidden, bf16, plan.resident, plan.pass_groups,
                                           plan.ahead)
    for _, rows in plan.slices:  # each launch's grid is resident at once
        row_blocks = -(-rows // (plan.groups * FWD_ROWS))
        assert row_blocks <= plan.row_blocks
        assert dirs * row_blocks * plan.unit_blocks <= H100["sms"] * plan.blocks_per_sm
    assert plan.blocks <= H100["sms"] * plan.blocks_per_sm


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("hidden", [1, 20, 496, 1024])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_batch_up_to_256_fits_one_launch(hidden, bf16, dirs):
    for batch in range(1, FWD_MAX_ROWS + 1):
        plan = forward_plan(batch, hidden, bf16, dirs, **H100)
        assert plan.slices == ((0, batch),), batch
        assert plan.blocks <= H100["sms"] * plan.blocks_per_sm, batch
        covered = plan.row_blocks * plan.groups * FWD_ROWS
        assert covered >= batch > (plan.row_blocks - 1) * plan.groups * FWD_ROWS, batch


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_fewest_launches_the_resident_grid_allows(batch, hidden, bf16, dirs):
    """As many launches as the rows need at 16 groups in each row block of the
    widest grid the card holds at once, of equal size in whole groups."""
    plan = forward_plan(batch, hidden, bf16, dirs, **H100)
    cap = launch_rows(hidden, dirs, sms=H100["sms"])
    assert len(plan.slices) == -(-batch // cap)
    assert all(1 <= n <= cap for _, n in plan.slices)
    assert all(n == plan.slices[0][1] and n % FWD_ROWS == 0 for _, n in plan.slices[:-1])


def test_launch_rows_at_the_model_widths():
    """16 groups of 16 rows in each of the row blocks that fit 132 SMs beside
    both directions' unit slices: 8 at H = 128 (2 x 8 unit slices), 2 at H =
    496 (2 x 31), 1 at H = 1024 (2 x 64), where a launch holds 256 rows as
    before."""
    assert launch_rows(128, 2, sms=132) == 2048
    assert launch_rows(496, 2, sms=132) == 512
    assert launch_rows(1024, 2, sms=132) == FWD_MAX_ROWS
    assert launch_rows(1024, 2, sms=16) == FWD_MAX_ROWS  # no grid fits: the plan raises
    assert launch_rows(128, 1, sms=132) == 16 * FWD_MAX_ROWS


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rows,launches,groups", [(2064, 2, 9), (4000, 2, 16), (10256, 6, 14)])
def test_dual_path_rows_share_launches(rows, launches, groups, bf16):
    """DPRNN's BiLSTM rows at H = 128 (a 16 x 2 s batch's intra rows, a 16 x
    10 s batch's inter and intra rows): the fewest launches of 8 row blocks,
    each block walking its groups in several passes a step with the next
    pass's h_{s-1} copied during this one; 256-row slices took 9, 16 and 41."""
    plan = forward_plan(rows, 128, bf16, 2, **H100)
    assert len(plan.slices) == launches and plan.groups == groups
    assert plan.row_blocks == 8 and plan.blocks == 128 and plan.resident
    assert plan.pass_groups == (8 if bf16 else 2) and plan.ahead
    assert plan.smem == forward_smem_bytes(128, bf16, True, plan.pass_groups, ahead=True)
    assert len(row_slices(rows)) == -(-rows // FWD_MAX_ROWS)


def _parent_plan(batch, hidden, bf16, dirs, *, sms, smem_optin, smem_per_sm):
    """The plan before a launch could take more than 256 rows: row slices of
    at most 256, the fewest groups a block whose grid is resident, as many
    groups a pass as fit, every pass's copies at its own top."""
    slices = row_slices(batch)
    unit_blocks = -(-hidden // FWD_UNITS)
    row_groups = -(-slices[0][1] // FWD_ROWS)
    resident, _, per_sm, groups = resident_tiling(
        bf16, lambda resident: forward_smem_bytes(hidden, bf16, resident),
        lambda groups: dirs * -(-row_groups // groups) * unit_blocks,
        sms=sms, smem_optin=smem_optin, smem_per_sm=smem_per_sm,
        blocks_per_sm=FWD_BLOCKS_PER_SM, max_groups=FWD_MAX_GROUPS,
    )
    passes = 1
    while passes * 2 <= min(groups, FWD_MAX_PASS[bf16]):
        wider = forward_smem_bytes(hidden, bf16, resident, passes * 2)
        if wider > smem_optin or per_sm * (wider + 1024) > smem_per_sm:
            break
        passes *= 2
    return ForwardPlan(groups, passes, resident, False,
                       forward_smem_bytes(hidden, bf16, resident, passes), unit_blocks,
                       -(-row_groups // groups), per_sm, dirs, slices)


@pytest.mark.parametrize("dirs", [1, 2])
@pytest.mark.parametrize("hidden", [1, 20, 128, 496, 1024])
@pytest.mark.parametrize("bf16", [False, True])
def test_batches_up_to_256_keep_the_parent_plan(hidden, bf16, dirs):
    """Every batch of 256 rows or fewer gets the plan it got when a launch
    took at most 256 rows: the same groups, passes, residency, grid and
    shared memory, so ``blstm_separate`` (H = 496, B <= 256) and the training
    bench (B = 32) launch the same instantiation."""
    for batch in range(1, FWD_MAX_ROWS + 1):
        want = _parent_plan(batch, hidden, bf16, dirs, **H100)
        assert forward_plan(batch, hidden, bf16, dirs, **H100) == want, batch


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch", [32, 256])
def test_training_and_serving_shapes_fill_the_card(batch, bf16):
    """B = 32 (training) and B = 256 (serving) at H = 496, both directions:
    2 row blocks x 31 unit slices x 2 = 124 blocks on 132 SMs, U resident; at
    B = 256 each block owns 8 groups of 16 rows, which bf16 multiplies in one
    pass (a warp each) and fp32 two at a time (four warps each)."""
    plan = forward_plan(batch, 496, bf16, 2, **H100)
    assert plan.blocks >= 120 and plan.blocks == 124
    assert plan.resident and plan.groups == batch // 32
    assert plan.pass_groups == (plan.groups if bf16 else min(plan.groups, 2))


def test_smem_layout_at_the_bench_width():
    """8 warps x 16 rows x 64 fp32 partials; h_{s-1} 16 x (496 + 8) a group of
    the pass; U's slice transposed, 64 x (496 + 8)."""
    partial = 8 * 16 * 64 * 4
    assert forward_smem_bytes(496, False, True) == partial + 4 * (16 * 504 + 64 * 504)
    assert forward_smem_bytes(496, True, True) == partial + 2 * (16 * 504 + 64 * 504)
    assert forward_smem_bytes(496, True, True, 8) == partial + 2 * (128 * 504 + 64 * 504)
    assert forward_smem_bytes(496, False, True, 2) == partial + 4 * (32 * 504 + 64 * 504)
    assert forward_smem_bytes(496, False, False) == partial + 4 * 16 * 504
    # copies ahead: two h buffers of a pass, 2 x 32 rows (fp32) or 2 x 128
    # (bf16) at H = 128, and two of its xw_t, rows of 64 + 16 columns
    assert forward_smem_bytes(128, False, True, 2, ahead=True) == (
        partial + 4 * ((64 + 64) * 136 + 64 * 80))
    assert forward_smem_bytes(128, True, True, 8, ahead=True) == (
        partial + 2 * ((256 + 64) * 136 + 256 * 80))


def test_no_room_to_copy_ahead_at_the_bench_width():
    """fp32 at H = 496 fills shared memory with one h buffer of two groups
    (226,304 bytes): a second does not fit, so ``blstm_separate`` keeps the
    instantiation without it, as do 512 rows there."""
    for batch in (256, 512):
        plan = forward_plan(batch, 496, False, 2, **H100)
        assert not plan.ahead and plan.smem == 226_304
        assert forward_smem_bytes(496, False, True, 2, ahead=True) > H100["smem_optin"]


def test_groups_a_pass_stop_where_shared_memory_does():
    """fp32 at B = 256, H = 496 has room for two groups' h beside U's slice
    (226,304 bytes), not four; bf16 for eight. At H = 1024 bf16 fits two."""
    assert forward_plan(256, 496, False, 2, **H100).pass_groups == 2
    assert forward_smem_bytes(496, False, True, 4) > H100["smem_optin"]
    assert forward_plan(256, 496, True, 2, **H100).pass_groups == 8
    assert forward_plan(256, 1024, True, 2, **H100).pass_groups == 2


@pytest.mark.parametrize("batch", [257, 300, 512, 1000, 4097])
def test_large_batches_split_into_row_slices(batch):
    """The training backward's slices of at most 256 rows (and the forward's
    rule at any cap)."""
    slices = row_slices(batch)
    assert len(slices) == -(-batch // FWD_MAX_ROWS)
    rows = np.concatenate([np.arange(start, start + n) for start, n in slices])
    assert (rows == np.arange(batch)).all()  # every row once, in order
    assert all(1 <= n <= FWD_MAX_ROWS for _, n in slices)
    assert all(n % FWD_ROWS == 0 for _, n in slices[:-1])


def test_wide_fp32_streams_u():
    """At H = 1024 fp32 a block's U slice (64 x 1,032 words) does not fit 227
    KB: the plan reads U through L1 from L2, and each of the 2 x 64 blocks owns
    all 16 groups of B = 256's rows. bf16's transposed slice fits."""
    plan = forward_plan(256, 1024, False, 2, **H100)
    assert not plan.resident and plan.groups == 16 and plan.blocks == 128
    assert forward_plan(256, 1024, True, 2, **H100).resident
    assert forward_plan(32, 608, False, 2, **H100).resident
    assert not forward_plan(32, 609, False, 2, **H100).resident


@pytest.mark.parametrize("batch,hidden,dirs", [(0, 496, 2), (32, 0, 2), (32, 1025, 2), (32, 496, 3)])
def test_out_of_range_shapes_raise(batch, hidden, dirs):
    with pytest.raises(ValueError, match=f"B={batch}, H={hidden}, D={dirs}"):
        forward_plan(batch, hidden, False, dirs, **H100)


def test_a_card_too_small_raises():
    with pytest.raises(ValueError, match="no resident grid"):
        forward_plan(256, 1024, False, 2, sms=16, smem_optin=232_448, smem_per_sm=233_472)


def test_tiling_constants_match_the_kernel_source():
    text = (CSRC / "lstm_recurrence.cu").read_text()
    found = {name: int(value) for name, value in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (found["kRows"], found["kUnits"], found["kMaxGroups"], found["kThreads"]) == (
        FWD_ROWS, FWD_UNITS, FWD_MAX_GROUPS, THREADS)
    pad = re.search(r"constexpr int kXStride = kCols \+ (\d+);", text)
    assert pad and 4 * FWD_UNITS + int(pad.group(1)) == FWD_X_STRIDE


def _c_entries() -> dict:
    """Each ``extern "C"`` entry of csrc/*.cu: its name and its parameters as
    ctypes would pass them (pointer, float or int)."""
    entries = {}
    for source in sorted(CSRC.glob("*.cu")):
        text = source.read_text()
        for name, params in re.findall(r'extern "C" [\w ]+?\**\s*(sst_\w+)\(([^)]*)\)', text):
            entries[name] = tuple(
                _build._P if "*" in p else _build._F if "float" in p else _build._I
                for p in params.split(",") if p.strip()
            )
    return entries


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_c_declarations(name):
    assert _c_entries()[name] == _build._SIGNATURES[name]


@pytest.mark.parametrize("seed", [0, 1])
def test_keep_gate_after_rounding_is_bit_identical(seed):
    """The kernel reads h_{s-1} back already rounded to bf16 and gates it by
    keep after the rounding; the plain version (and the TPU kernel) gate
    before it. For keep in {0, 1}, all that segment_keep makes, the two agree
    bit for bit."""
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((64, 496)).astype(np.float32))
    keep = torch.from_numpy((rng.random((64, 1)) > 0.5).astype(np.float32))
    before = (h * keep).to(torch.bfloat16)
    after = (h.to(torch.bfloat16).float() * keep).to(torch.bfloat16)
    assert torch.equal(before.view(torch.int16), after.view(torch.int16))
