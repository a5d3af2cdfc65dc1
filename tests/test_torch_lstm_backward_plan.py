"""PyTorch port: the launch plan of the persistent LSTM backward kernel, on the CPU.

``ops/lstm_train_cuda.py::backward_plan`` tiles ``csrc/lstm_train_backward.cu``'s
one cooperative launch from the card's SM count and shared memory. A plan is
right when every (direction, batch row, hidden unit) is owned by exactly one
thread of one block, when a block's shared memory fits the card's opt-in
limit, and when the whole grid fits the card at once (a cooperative launch
that cannot is refused). These tests check that arithmetic with an H100's
figures; the kernel itself runs in ``test_torch_cuda.py`` on a GPU.
"""

import numpy as np
import pytest

from speech_separation_tpu_torch.ops.lstm_train_cuda import (
    BWD_ROWS,
    BWD_UNITS,
    backward_plan,
    backward_smem_bytes,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an SM
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472}
THREADS = 256
# (B, H): the tests' ragged shapes, the CLI's batch, the bench's, two groups
# a block, the widest batch, and the widest hidden size the kernel takes
SHAPES = [(3, 20), (33, 40), (4, 496), (32, 496), (64, 496), (256, 496), (1, 1024), (256, 1024)]


def _owners(plan, batch, hidden):
    """How many threads own each (direction, row, unit), walking the grid as
    the kernel does: block (unit slice, row block, direction), group g, thread
    (row, unit) = (tid / 16, tid % 16)."""
    count = np.zeros((2, batch, hidden), dtype=np.int64)
    for d in range(2):
        for rb in range(plan.row_blocks):
            for us in range(plan.unit_blocks):
                for g in range(plan.groups):
                    b0 = (rb * plan.groups + g) * BWD_ROWS
                    if b0 >= batch:
                        break
                    for tid in range(THREADS):
                        b, j = b0 + tid // BWD_UNITS, us * BWD_UNITS + tid % BWD_UNITS
                        if b < batch and j < hidden:
                            count[d, b, j] += 1
    return count


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_every_row_and_unit_is_owned_once(batch, hidden, bf16):
    plan = backward_plan(batch, hidden, bf16, **H100)
    assert (_owners(plan, batch, hidden) == 1).all()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("batch,hidden", SHAPES)
def test_plan_fits_the_card(batch, hidden, bf16):
    plan = backward_plan(batch, hidden, bf16, **H100)
    assert plan.smem == backward_smem_bytes(hidden, bf16, plan.resident)
    assert plan.smem <= H100["smem_optin"]
    assert plan.blocks_per_sm * (plan.smem + 1024) <= H100["smem_per_sm"]
    assert plan.blocks <= H100["sms"] * plan.blocks_per_sm
    assert plan.unit_blocks * BWD_UNITS >= hidden
    assert plan.row_blocks * plan.groups * BWD_ROWS >= batch


def test_bench_shape_keeps_u_resident_with_one_group():
    """B = 32, H = 496: U's slice in shared memory (16 x 2,048 columns), one
    group of 16 rows a block: 2 directions x 2 row blocks x 31 unit slices,
    124 blocks on 132 SMs."""
    for bf16 in (False, True):
        plan = backward_plan(32, 496, bf16, **H100)
        assert plan.resident and plan.groups == 1 and plan.blocks == 124
    # 8 warps x 16 x 16 fp32 partials; three fp32 buffers of 16 x (256 + 8);
    # U 16 x (2,048 + 8) fp32; bf16: one buffer of 16 x (1,024 + 8), U in bf16
    assert backward_plan(32, 496, False, **H100).smem == 8_192 + 4 * (3 * 16 * 264 + 16 * 2_056)
    assert backward_plan(32, 496, True, **H100).smem == 8_192 + 2 * (16 * 1_032 + 16 * 2_056)


@pytest.mark.parametrize("hidden", [20, 496, 1024])
@pytest.mark.parametrize("bf16", [False, True])
def test_every_batch_up_to_256_fits(hidden, bf16):
    for batch in range(1, 257):
        plan = backward_plan(batch, hidden, bf16, **H100)
        assert plan.blocks <= H100["sms"] * plan.blocks_per_sm, batch
        assert plan.row_blocks * plan.groups * BWD_ROWS >= batch > (plan.row_blocks - 1) * plan.groups * BWD_ROWS


def test_wide_fp32_streams_u():
    """At H = 1024 fp32 a block's U slice (16 x 4,096 x 4 bytes) and its
    three staging buffers do not fit 227 KB: the plan streams U from L2, and
    each of the 2 x 64 blocks owns all 16 groups of B = 256's rows."""
    plan = backward_plan(256, 1024, False, **H100)
    assert not plan.resident and plan.groups == 16 and plan.blocks == 128
    assert backward_plan(256, 1024, True, **H100).resident


@pytest.mark.parametrize("batch,hidden", [(0, 496), (257, 496), (32, 0), (32, 1025)])
def test_out_of_range_shapes_raise(batch, hidden):
    with pytest.raises(ValueError, match=f"B={batch}, H={hidden}"):
        backward_plan(batch, hidden, False, **H100)


def test_a_card_too_small_raises():
    with pytest.raises(ValueError, match="no resident grid"):
        backward_plan(256, 1024, False, sms=16, smem_optin=232_448, smem_per_sm=233_472)
