"""PyTorch port: the launch plan of the persistent LSTM forward kernel, on the CPU.

``ops/lstm_cuda.py::forward_plan`` tiles ``csrc/lstm_recurrence.cu``'s
cooperative launches (serving and training forward) from the card's SM count
and shared memory, and cuts a batch above 256 rows into row slices, one launch
each. A plan is right when every (direction, batch row, hidden unit) is owned
by exactly one thread of one block of one launch, when a block's shared memory
fits the card's opt-in limit, and when each launch's grid fits the card at
once (a cooperative launch that cannot is refused). These tests check that
arithmetic with an H100's figures, and that the ctypes signatures match the C
entry points; the kernel itself runs in ``test_torch_cuda.py`` on a GPU.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.ops.lstm_cuda import (
    FWD_MAX_GROUPS,
    FWD_MAX_PASS,
    FWD_MAX_ROWS,
    FWD_ROWS,
    FWD_UNITS,
    forward_plan,
    forward_smem_bytes,
    row_slices,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an SM
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472}
THREADS = 256
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
# (B, H): ragged shapes, the CLI's batch, the training bench's, two row
# blocks, the serving bench's, the widest hidden size, and row slices
SHAPES = [(3, 20), (33, 40), (4, 496), (32, 496), (64, 496), (256, 496), (1, 1024),
          (256, 1024), (300, 496), (1000, 1024)]


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
    assert plan.smem == forward_smem_bytes(hidden, bf16, plan.resident, plan.pass_groups)
    assert plan.smem <= H100["smem_optin"]
    # a power of two, at most the groups a block owns and the type's limit
    assert plan.pass_groups & (plan.pass_groups - 1) == 0
    assert 1 <= plan.pass_groups <= min(plan.groups, FWD_MAX_PASS[bf16])
    assert plan.blocks_per_sm * (plan.smem + 1024) <= H100["smem_per_sm"]
    assert plan.unit_blocks * FWD_UNITS >= hidden
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


def test_groups_a_pass_stop_where_shared_memory_does():
    """fp32 at B = 256, H = 496 has room for two groups' h beside U's slice
    (226,304 bytes), not four; bf16 for eight. At H = 1024 bf16 fits two."""
    assert forward_plan(256, 496, False, 2, **H100).pass_groups == 2
    assert forward_smem_bytes(496, False, True, 4) > H100["smem_optin"]
    assert forward_plan(256, 496, True, 2, **H100).pass_groups == 8
    assert forward_plan(256, 1024, True, 2, **H100).pass_groups == 2


@pytest.mark.parametrize("batch", [257, 300, 512, 1000, 4097])
def test_large_batches_split_into_row_slices(batch):
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


def _c_entries() -> dict:
    """Each ``extern "C"`` entry of csrc/*.cu: its name and its parameters as
    ctypes would pass them (pointer or int)."""
    entries = {}
    for source in sorted(CSRC.glob("*.cu")):
        text = source.read_text()
        for name, params in re.findall(r'extern "C" [\w ]+?\**\s*(sst_\w+)\(([^)]*)\)', text):
            entries[name] = tuple(
                _build._P if "*" in p else _build._I for p in params.split(",") if p.strip()
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
