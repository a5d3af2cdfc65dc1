"""PyTorch port: the launch plan and reduction order of the Conv-TasNet trunk
kernel, on the CPU.

``ops/tcn_cuda.py::trunk_plan`` sizes ``csrc/tcn_trunk.cu``'s one cooperative
launch a call from the card's SM count, shared memory and L2: ``groups`` items
in flight, each owned by a group of ``ctas`` CTAs that walks all its blocks
and owns the 128-row tiles ``rank, rank + ctas, ...`` in every phase. A plan is
right when every (item, block, phase, tile) and every output column or
channel slice is owned exactly once, when the items in flight and the weights
fit the L2 budget (or one item is in flight), when a CTA's shared memory fits
and the grid is resident at once (one CTA an SM), and when (B)'s staging
holds a tile's rows and the taps' halo. These tests check that arithmetic
with an H100's figures, the tiling constants and ctypes signatures against
the sources, and a PyTorch model of the kernel's order of summing the gLN
statistics against the plain trunk and JAX's Pallas trunk in interpret mode.
The kernel itself runs in ``test_torch_cuda.py`` on a GPU.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu.ops import tcn_pallas as jtcn
from speech_separation_tpu.ops import tcn_train_pallas as jtrain
from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.ops.tcn_cuda import (
    MAX_DILATION,
    TRUNK_DEPTH,
    TRUNK_MAX_BLOCKS,
    TRUNK_MAX_TAPS,
    TRUNK_SLICE,
    TRUNK_STAGES,
    TRUNK_THREADS,
    TRUNK_TILE_COLS,
    TRUNK_TILE_ROWS,
    fold_canonical,
    tcn_trunk_plain,
    trunk_forward_plain,
    trunk_plan,
    trunk_smem_bytes,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an
# SM, 50 MB of L2
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472, "l2_bytes": 52_428_800}
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
DILS21 = tuple(2**x for _ in range(3) for x in range(7))  # the JAX defaults: X = 7, R = 3
WIDTHS = [(32, 48), (128, 256), (256, 512)]
# (B, K): one item and one frame, K below the largest dilation's halo, ragged
# K, the serving benches (64 x 8 s at win 16 and 32), the training bench,
# long items, and batches past the items in flight
SHAPES = [(1, 1), (3, 50), (2, 130), (4, 8003), (64, 8000), (64, 4000), (16, 4000), (7, 3000),
          (1, 16000), (256, 16000), (256, 1), (200, 777)]
# A sum in another order flips a bf16 rounding by one ulp (2^-8), which later
# blocks carry: the kernels' bound against the plain trunk (chip_smoke.py)
TRUNK_BF16_REL = 3e-2
STATS_REL = 1e-4  # a statistic column, fp32 sums over (K, ch) in two orders
TRUNK_DB = 40.0  # plain trunk against the Pallas trunk in bf16 (test_torch_tasnet.py)
BF16_PRIMAL_DB = 34.0  # against tcn_trunk_train in interpret mode (test_torch_tcn_train.py)


def _owners(plan, batch, frames, cb, ch):
    """How many CTAs own each (item, tile) in a phase, each column of (A) and
    (C) and each channel slice of (B), walking the kernel's loops."""
    tiles = np.zeros((batch, plan.tiles), dtype=np.int64)
    for g in range(plan.groups):
        for item in range(g, batch, plan.groups):
            for rank in range(plan.ctas):
                for tile in range(rank, plan.tiles, plan.ctas):
                    tiles[item, tile] += 1
    cols = {}
    for phase, width, step in (("A", ch, TRUNK_TILE_COLS), ("B", ch, TRUNK_SLICE),
                               ("C", 2 * cb, TRUNK_TILE_COLS)):
        count = np.zeros(width, dtype=np.int64)
        for col0 in range(0, width, step):
            count[col0:col0 + step] += 1
        cols[phase] = count
    rows = np.zeros((batch, frames), dtype=np.int64)
    for item in range(batch):
        for tile in range(plan.tiles):
            r0 = tile * TRUNK_TILE_ROWS
            rows[item, r0:min(r0 + TRUNK_TILE_ROWS, frames)] += tiles[item, tile]
    return tiles, rows, cols


@pytest.mark.parametrize("cb,ch", WIDTHS)
@pytest.mark.parametrize("batch,frames", SHAPES)
def test_every_item_block_phase_and_tile_is_owned_once(batch, frames, cb, ch):
    plan = trunk_plan(batch, frames, cb, ch, 3, DILS21, **H100)
    tiles, rows, cols = _owners(plan, batch, frames, cb, ch)
    # every group walks every block of its items, and (A), (B), (C) share the tiles
    assert (tiles == 1).all() and (rows == 1).all()
    assert all((c == 1).all() for c in cols.values())
    assert plan.tiles == -(-frames // TRUNK_TILE_ROWS)


@pytest.mark.parametrize("cb,ch", WIDTHS)
@pytest.mark.parametrize("batch,frames", SHAPES)
def test_plan_fits_the_card_and_the_l2_budget(batch, frames, cb, ch):
    plan = trunk_plan(batch, frames, cb, ch, 3, DILS21, **H100)
    assert plan.smem <= H100["smem_optin"] and plan.smem <= 227 * 1024
    # a cooperative launch, one CTA an SM: the whole grid resident at once
    assert 1 <= plan.grid <= H100["sms"]
    assert 1 <= plan.ctas <= plan.tiles and 1 <= plan.groups <= batch
    assert plan.item_bytes == 2 * frames * (2 * cb + 2 * ch)  # h, skip, t1, t2 in bf16
    assert plan.l2_budget < H100["l2_bytes"]
    assert plan.resident or plan.groups == 1
    assert plan.groups * plan.item_bytes + plan.weight_bytes <= plan.l2_budget or plan.groups == 1


@pytest.mark.parametrize("taps", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("max_dil", [1, 7, 64])
def test_staging_holds_the_tile_and_its_halo(taps, max_dil):
    dils = (1, max_dil, 1)
    plan = trunk_plan(4, 1000, 128, 256, taps, dils, **H100)
    pad = (taps - 1) * max_dil // 2
    # rows below and above a tile that its taps read: pad and the rest of the reach
    assert plan.halo >= 2 * pad and plan.halo >= (taps - 1) * max_dil - pad
    assert plan.halo == (taps - 1) * max_dil
    buffer = -(-((TRUNK_TILE_ROWS + plan.halo) * TRUNK_SLICE * 2) // 1024) * 1024
    assert plan.smem <= H100["smem_optin"]
    assert plan.smem == trunk_smem_bytes(taps, max_dil, 128, 256)
    assert plan.smem - 1024 - 4 * ((6 + taps) * 256 + 4 * 128) >= 2 * buffer  # the vectors after it


def test_bench_shapes_fill_the_card_one_tile_a_cta():
    # 64 x 8 s at win 16: K = 8000, 63 tiles; two 12.3 MB items in flight
    plan = trunk_plan(64, 8000, 128, 256, 3, DILS21, **H100)
    assert (plan.groups, plan.ctas, plan.grid) == (2, 63, 126) and plan.resident
    # win 32 (K = 4000) and the training bench (16 x 4 s at win 16)
    for batch in (64, 16):
        plan = trunk_plan(batch, 4000, 128, 256, 3, DILS21, **H100)
        assert (plan.groups, plan.ctas, plan.grid) == (4, 32, 128) and plan.resident


def test_batches_past_the_items_in_flight_take_several_waves():
    plan = trunk_plan(7, 3000, 128, 256, 3, DILS21, **H100)
    assert plan.groups < 7 and -(-7 // plan.groups) >= 2


def test_out_of_range_shapes_raise():
    with pytest.raises(ValueError, match="taps"):
        trunk_plan(1, 100, 32, 48, TRUNK_MAX_TAPS + 1, (1,), **H100)
    with pytest.raises(ValueError, match="blocks"):
        trunk_plan(1, 100, 32, 48, 3, (1,) * (TRUNK_MAX_BLOCKS + 1), **H100)
    with pytest.raises(ValueError, match="K=0"):
        trunk_plan(1, 0, 32, 48, 3, (1,), **H100)
    with pytest.raises(ValueError, match="shared memory"):
        trunk_plan(1, 100, 32, 48, 3, (1,), **dict(H100, smem_optin=100_000))


def test_tiling_constants_match_the_kernel_source():
    common = (CSRC / "tcn_common.cuh").read_text() + (CSRC / "tcn_trunk.cu").read_text()
    found = {name: int(value) for name, value in
             re.findall(r"constexpr int (k\w+) = (\d+);", common)}
    assert (found["kThreads"], found["kEngRows"], found["kEngCols"], found["kEngDepth"],
            found["kEngStages"], found["kSliceCh"], found["kMaxTaps"], found["kMaxBlocks"]) == (
        TRUNK_THREADS, TRUNK_TILE_ROWS, TRUNK_TILE_COLS, TRUNK_DEPTH, TRUNK_STAGES, TRUNK_SLICE,
        TRUNK_MAX_TAPS, TRUNK_MAX_BLOCKS)
    assert MAX_DILATION == 64


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


def _trunk_inputs(batch, frames, cb, ch, dils, seed):
    """The kernel's folded arrays (stack_tcn_weights' layout, which JAX's
    tcn_trunk_pallas takes too), from numpy, gammas and slopes perturbed."""
    rng = np.random.default_rng(seed)
    n, vdim = len(dils), max(ch, 2 * cb)
    canon = [
        (rng.standard_normal((n, cb, ch)) / np.sqrt(cb)).astype(np.float32),
        (rng.standard_normal((n, 3, ch)) / np.sqrt(3)).astype(np.float32),
        (rng.standard_normal((n, ch, 2 * cb)) / np.sqrt(ch)).astype(np.float32),
        (rng.standard_normal((n, 10, vdim)) * 0.1).astype(np.float32),
    ]
    canon[3][:, 1] += 1.0  # gammas near 1
    canon[3][:, 4] += 1.0
    canon[3][:, 7] = 0.0
    canon[3][:, 8], canon[3][:, 9] = 0.25, 0.2  # PReLU slopes, broadcast
    h0 = rng.standard_normal((batch, frames, cb)).astype(np.float32)
    return h0, canon, fold_canonical(*(torch.from_numpy(a) for a in canon))


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


DILS8 = (1, 2, 4, 8, 16, 32, 64, 1)


@pytest.mark.parametrize("ctas", [1, 4, 9])
def test_kernel_reduction_order_matches_the_plain_trunk(ctas):
    """The statistics summed as the kernel sums them (each CTA's partial over
    its tiles, the partials in rank order) against one tensor sum: the
    statistics within fp32 noise, the skip sum within the kernels' bound."""
    h0, _, folded = _trunk_inputs(2, 1100, 32, 48, DILS8, seed=3)  # 9 tiles of 128 rows
    x = torch.from_numpy(h0)
    want = trunk_forward_plain(x, *folded, dils=DILS8, residuals=True)
    got = trunk_forward_plain(x, *folded, dils=DILS8, residuals=True, ctas=ctas)
    for col in range(4):  # mu1, 1/sigma1, mu2, 1/sigma2
        rel = ((got[2][..., col] - want[2][..., col]).norm() / want[2][..., col].norm()).item()
        assert rel <= STATS_REL, (col, rel)
    bound = TRUNK_BF16_REL * max(1.0, want[0].float().abs().max().item())
    assert (got[0].float() - want[0].float()).abs().max().item() <= bound
    assert torch.equal(tcn_trunk_plain(x, *folded, dils=DILS8), want[0])


@pytest.mark.parametrize("k", [130, 200])
def test_kernel_reduction_order_matches_pallas_interpret(k):
    """The model of the kernel's order against JAX's TPU trunk kernel, run in
    interpret mode at a narrow width, as the plain trunk is held to it."""
    h0, _, folded = _trunk_inputs(2, k, 16, 32, DILS8, seed=4)
    plan = trunk_plan(2, k, 16, 32, 3, DILS8, **H100)
    got = trunk_forward_plain(torch.from_numpy(h0), *folded, dils=DILS8, ctas=plan.ctas)[0]
    want = jtcn.tcn_trunk_pallas(jnp.asarray(h0), *(jnp.asarray(t.numpy()) if t.dtype != torch.bfloat16
                                                    else jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                                                    for t in folded), dils=DILS8, interpret=True)
    assert _snr_db(np.asarray(want.astype(jnp.float32)), got.float().numpy()) >= TRUNK_DB


def test_kernel_reduction_order_matches_the_jax_training_trunk():
    """The training forward with the kernel's order against JAX's
    tcn_trunk_train in interpret mode (its forward folds gamma2 / sigma2 per
    item before its bf16 cast, so the two round at other places)."""
    dils = (1, 2, 4, 1, 2, 4)
    h0, canon, folded = _trunk_inputs(2, 130, 16, 32, dils, seed=5)
    got = trunk_forward_plain(torch.from_numpy(h0), *folded, dils=dils, residuals=True, ctas=2)
    want = jtrain.tcn_trunk_train(*map(jnp.asarray, [h0, *canon]), dils=dils, taps=3, chunk=512,
                                  interpret=True)
    assert _snr_db(np.asarray(want.astype(jnp.float32)), got[0].float().numpy()) >= BF16_PRIMAL_DB
    assert got[1].shape == (len(dils), 2, 130, 16) and got[2].shape == (len(dils), 2, 4)
