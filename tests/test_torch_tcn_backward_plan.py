"""PyTorch port: the launch plan and reduction order of the Conv-TasNet trunk
backward kernel, on the CPU.

``ops/tcn_train_cuda.py::backward_plan`` sizes ``csrc/tcn_train_backward.cu``'s
one cooperative launch a call from the card's SM count and shared memory:
``groups`` items in flight, each owned by a group of ``ctas`` CTAs that walks
its blocks in reverse and owns the 128-row tiles ``rank, rank + ctas, ...`` in
every phase (P1 to P6). Each CTA keeps an fp32 partial of every block's weight
gradients (128 x 128 tiles of dWcat and dWe) and column sums, summed over the
CTAs in order after the last item. A plan is right when every (item, block,
phase, tile) is owned exactly once and every weight-gradient element by one
tile, when it takes the fewest rounds and then the fewest items a group walks
(its L2 accounting reported, not a limit: more items in flight measured
faster on an NVIDIA H100), when a CTA's shared memory fits and the grid is
resident at once (one CTA an SM), when P2's and P5's staging holds a tile's
rows and the taps' halo, and when the partials' scratch is what the wrapper
allocates. These tests check that arithmetic with an H100's figures, the constants and
the ctypes signature against the source, and a PyTorch model of the kernel's
order of sums (``tcn_train_backward_plain(ctas=...)``) against the plain
backward and JAX's ``tcn_trunk_train`` gradients in interpret mode. The
kernel itself runs in ``test_torch_cuda.py`` on a GPU.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.ops import tcn_train_pallas as jtrain
from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.ops.tcn_cuda import (
    MAX_DILATION,
    TRUNK_MAX_BLOCKS,
    TRUNK_MAX_TAPS,
    TRUNK_SLICE,
    TRUNK_TILE_ROWS,
    fold_canonical,
)
from speech_separation_tpu_torch.ops.tcn_train_cuda import (
    BWD_COLRED,
    BWD_TILE_COLS,
    BWD_VEC_ROWS,
    TRUNK_BWD_LAPS,
    backward_plan,
    backward_smem_bytes,
    tcn_train_backward_plain,
    tcn_train_forward_plain,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an
# SM, 50 MB of L2
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472, "l2_bytes": 52_428_800}
SOURCE = pathlib.Path(_build.__file__).resolve().parent / "csrc" / "tcn_train_backward.cu"
DILS21 = tuple(2**x for _ in range(3) for x in range(7))  # the JAX defaults: X = 7, R = 3
WIDTHS = [(32, 48), (128, 256), (256, 512)]
# (B, K): one item and one frame, K below the largest dilation's halo, ragged
# K, the training bench (16 x 4 s at win 16), long items, and batches past the
# items in flight
SHAPES = [(1, 1), (3, 50), (2, 130), (4, 4003), (16, 4000), (7, 3000), (1, 16000),
          (256, 16000), (256, 1), (200, 777)]
PHASES = ("P1", "P2", "P3", "P4", "P5", "P6")
# fp32 storage: the model and the plain backward differ only in the order of
# fp32 sums (over up to 2 x 1100 frames): measured <= 6e-7 rel L2
FP32_ORDER_REL = 1e-5
# bf16 storage: a sum in another order can flip a stored bf16 rounding by one
# ulp (2^-8), which later blocks carry: the kernel's bound against the plain
# backward (chip_smoke.py, test_torch_cuda.py); measured <= 2.6e-3 here
TRAIN_TRUNK_GRAD_REL = 3e-2
# against tcn_trunk_train(interpret=True) in bf16, the port's chain with the
# kernel's order: the bound test_torch_tcn_train.py holds the plain chain to
BF16_GRAD_DB = 12.0


def _walk(plan, batch, n_blocks):
    """How many CTAs own each (item, block, phase, tile), walking the kernel's
    loops: group g takes items g, g + groups, ..., each block in reverse."""
    owned = np.zeros((batch, n_blocks, len(PHASES), plan.tiles), dtype=np.int64)
    for g in range(plan.groups):
        for item in range(g, batch, plan.groups):
            for j in reversed(range(n_blocks)):
                for ph in range(len(PHASES)):
                    for rank in range(plan.ctas):
                        for tile in range(rank, plan.tiles, plan.ctas):
                            owned[item, j, ph, tile] += 1
    return owned


def _weight_tile_cover(cb, ch):
    """How many of the kernel's 128 x 128 weight-gradient tiles (dWcat's in
    (m, n) order, then dWe's) cover each element of dWcat [ch, 2cb] and dWe
    [cb, ch]."""
    cat = np.zeros((ch, 2 * cb), dtype=np.int64)
    we = np.zeros((cb, ch), dtype=np.int64)
    tiles = 0
    for out in (cat, we):
        for m0 in range(0, out.shape[0], TRUNK_TILE_ROWS):
            for n0 in range(0, out.shape[1], BWD_TILE_COLS):
                out[m0:m0 + TRUNK_TILE_ROWS, n0:n0 + BWD_TILE_COLS] += 1
                tiles += 1
    return cat, we, tiles


@pytest.mark.parametrize("cb,ch", WIDTHS)
@pytest.mark.parametrize("batch,frames", SHAPES)
def test_every_item_block_phase_and_tile_is_owned_once(batch, frames, cb, ch):
    plan = backward_plan(batch, frames, cb, ch, 3, DILS21, **H100)
    assert plan.tiles == -(-frames // TRUNK_TILE_ROWS)
    if batch * plan.tiles <= 4096:  # the walk, where it is quick
        assert (_walk(plan, batch, len(DILS21)) == 1).all()
    else:  # the same ownership, by arithmetic: items by groups, tiles by ranks
        items = [len(range(g, batch, plan.groups)) for g in range(plan.groups)]
        tiles = [len(range(r, plan.tiles, plan.ctas)) for r in range(plan.ctas)]
        assert sum(items) == batch and sum(tiles) == plan.tiles
    cat, we, tiles = _weight_tile_cover(cb, ch)
    assert (cat == 1).all() and (we == 1).all() and tiles == plan.weight_tiles


@pytest.mark.parametrize("cb,ch", WIDTHS)
@pytest.mark.parametrize("batch,frames", SHAPES)
def test_plan_fits_the_card_in_the_fewest_rounds(batch, frames, cb, ch):
    plan = backward_plan(batch, frames, cb, ch, 3, DILS21, **H100)
    assert plan.smem <= H100["smem_optin"] and plan.smem + 2048 <= H100["smem_per_sm"]
    # a cooperative launch, one CTA an SM: the whole grid resident at once
    assert 1 <= plan.grid <= H100["sms"]
    assert 1 <= plan.ctas <= plan.tiles and 1 <= plan.groups <= batch
    # the fewest rounds (items a group times tiles a CTA), then the fewest
    # items a group walks, then the fewest groups, over every group count
    keys = []
    for groups in range(1, min(batch, H100["sms"]) + 1):
        ctas = min(plan.tiles, H100["sms"] // groups)
        visits = -(-batch // groups)
        keys.append((visits * -(-plan.tiles // ctas), visits, groups, ctas))
    assert min(keys)[2:] == (plan.groups, plan.ctas)
    # the L2 accounting it reports: t1 and dd in bf16, the dh and dskip
    # carries in fp32, and the slabs only their owner reads back
    assert plan.item_bytes == frames * (2 * 2 * ch + 2 * 4 * cb)
    assert plan.slab_bytes == 2 * frames * (3 * ch + 2 * cb)  # d, n2/dt1p, dxh, drs
    assert plan.l2_budget < H100["l2_bytes"]
    assert plan.resident == (plan.groups * plan.item_bytes + plan.weight_bytes <= plan.l2_budget)


@pytest.mark.parametrize("cb,ch", WIDTHS)
@pytest.mark.parametrize("taps", [1, 3, 5])
def test_partials_scratch_matches_the_plan(cb, ch, taps):
    dils = (1, 2, 4)
    plan = backward_plan(16, 4000, cb, ch, taps, dils, **H100)
    vdim = max(ch, 2 * cb)
    wtiles = -(-ch // 128) * -(-2 * cb // 128) + -(-cb // 128) * -(-ch // 128)
    assert plan.weight_tiles == wtiles
    per_cta = len(dils) * (wtiles * TRUNK_TILE_ROWS * BWD_TILE_COLS + (BWD_VEC_ROWS + taps) * vdim)
    assert plan.partial_bytes == 4 * plan.grid * per_cta


@pytest.mark.parametrize("taps", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("max_dil", [1, 7, 64])
def test_staging_holds_the_tile_and_its_halo(taps, max_dil):
    dils = (1, max_dil, 1)
    smem = backward_smem_bytes(taps, max_dil, 128, 256)
    if smem > H100["smem_optin"]:  # P5's two pairs of buffers do not fit: refused
        with pytest.raises(ValueError, match="shared memory"):
            backward_plan(4, 1000, 128, 256, taps, dils, **H100)
        return
    plan = backward_plan(4, 1000, 128, 256, taps, dils, **H100)
    pad = (taps - 1) * max_dil // 2
    # rows below and above a tile that the taps (and their transposes) read
    assert plan.halo >= 2 * pad and plan.halo >= (taps - 1) * max_dil - pad
    assert plan.halo == (taps - 1) * max_dil
    buffer = -(-((TRUNK_TILE_ROWS + plan.halo) * TRUNK_SLICE * 2) // 1024) * 1024
    assert plan.smem == smem
    vectors = 4 * ((8 + taps) * 256 + BWD_COLRED + (BWD_VEC_ROWS + taps) * 256 + 128)
    assert plan.smem - 1024 - vectors >= 4 * buffer  # P5: dd and t1, double-buffered


def test_the_training_bench_takes_every_item_at_once():
    # 16 x 4 s at win 16: K = 4000, 32 tiles; every item in flight, 4 tiles a
    # CTA, so each CTA writes each block's partials once (measured faster on
    # an NVIDIA H100 than 4 groups of 32 CTAs, whose items fit the L2 budget)
    plan = backward_plan(16, 4000, 128, 256, 3, DILS21, **H100)
    assert (plan.groups, plan.ctas, plan.grid) == (16, 8, 128) and not plan.resident
    assert plan.weight_tiles == 6
    assert plan.partial_bytes == 4 * 128 * 21 * (6 * 128 * 128 + 13 * 256)  # 1.09 GB


def test_batches_past_the_items_in_flight_take_several_rounds():
    # more items than SMs: a group walks two, adding to its partials
    plan = backward_plan(140, 50, 128, 256, 3, DILS21, **H100)
    assert plan.groups < 140 and -(-140 // plan.groups) == 2 and plan.ctas == 1
    plan = backward_plan(7, 3000, 128, 256, 3, DILS21, **H100)
    assert (plan.groups, plan.ctas) == (7, 18)  # 24 tiles: some CTAs take two


def test_out_of_range_shapes_raise():
    with pytest.raises(ValueError, match="taps"):
        backward_plan(1, 100, 32, 48, TRUNK_MAX_TAPS + 1, (1,), **H100)
    with pytest.raises(ValueError, match="blocks"):
        backward_plan(1, 100, 32, 48, 3, (1,) * (TRUNK_MAX_BLOCKS + 1), **H100)
    with pytest.raises(ValueError, match="K=0"):
        backward_plan(1, 0, 32, 48, 3, (1,), **H100)
    with pytest.raises(ValueError, match="dilations"):
        backward_plan(1, 100, 32, 48, 3, (1, MAX_DILATION + 1), **H100)
    with pytest.raises(ValueError, match="multiples of 8"):
        backward_plan(1, 100, 36, 48, 3, (1,), **H100)
    with pytest.raises(ValueError, match="shared memory"):
        backward_plan(1, 100, 32, 48, 3, (1,), **dict(H100, smem_optin=100_000))


def test_constants_match_the_kernel_source():
    text = (SOURCE.parent / "tcn_common.cuh").read_text() + SOURCE.read_text()
    found = {name: int(value) for name, value in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (found["kMaxTaps"], found["kMaxBlocks"], found["kSliceCh"], found["kVecRows"],
            found["kCols"]) == (TRUNK_MAX_TAPS, TRUNK_MAX_BLOCKS, TRUNK_SLICE, BWD_VEC_ROWS,
                                BWD_TILE_COLS)
    assert re.search(r"kColRed = \(2 \+ kMaxTaps\) \* kSliceCh \* kWarps;", text)
    assert BWD_COLRED == (2 + TRUNK_MAX_TAPS) * TRUNK_SLICE * 8  # 8 warps
    laps = re.search(r"enum Lap \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"^\s*(kLap\w+)", laps, re.M)
    assert names[-1] == "kLaps" and len(names) - 1 == len(TRUNK_BWD_LAPS)


def test_signature_matches_the_c_declaration():
    params = re.search(r'extern "C" int sst_tcn_trunk_backward\(([^)]*)\)', SOURCE.read_text())
    kinds = tuple(_build._P if "*" in p else _build._I for p in params.group(1).split(","))
    assert kinds == _build._SIGNATURES["sst_tcn_trunk_backward"]
    assert kinds.count(_build._P) == 20 and kinds.count(_build._I) == 9


DILS8 = (1, 2, 4, 8, 16, 32, 64, 1)


def _inputs(batch, frames, cb, ch, dils, seed):
    """The canonical arrays and h0, dskip from numpy, gammas and slopes perturbed."""
    rng = np.random.default_rng(seed)
    n, vdim = len(dils), max(ch, 2 * cb)
    vecs = (rng.standard_normal((n, 10, vdim)) * 0.1).astype(np.float32)
    vecs[:, 1] += 1.0  # gammas near 1
    vecs[:, 4] += 1.0
    vecs[:, 7] = 0.0
    vecs[:, 8], vecs[:, 9] = 0.25, 0.2  # PReLU slopes, broadcast
    arrays = [
        rng.standard_normal((batch, frames, cb)).astype(np.float32),
        (rng.standard_normal((n, cb, ch)) / np.sqrt(cb)).astype(np.float32),
        (rng.standard_normal((n, 3, ch)) / np.sqrt(3)).astype(np.float32),
        (rng.standard_normal((n, ch, 2 * cb)) / np.sqrt(ch)).astype(np.float32),
        vecs,
    ]
    dskip = rng.standard_normal((batch, frames, cb)).astype(np.float32)
    return arrays, dskip


def _rel(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


@functools.lru_cache(maxsize=None)
def _residuals(storage):
    """The plain forward's residuals and the plain backward, at 2 x 1100 frames
    (9 tiles of 128 rows), narrow widths."""
    arrays, dskip = _inputs(2, 1100, 32, 48, DILS8, seed=7)
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    _, hb, st = tcn_train_forward_plain(h0, *fold_canonical(*canon, storage), dils=DILS8,
                                        storage=storage)
    dskip = torch.from_numpy(dskip)
    want = tcn_train_backward_plain(dskip, hb, st, *canon, dils=DILS8, storage=storage)
    return dskip, hb, st, canon, want


@pytest.mark.parametrize("storage", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("ctas,groups", [(1, 1), (4, 1), (9, 1), (4, 2)])
def test_kernel_order_of_sums_matches_the_plain_backward(ctas, groups, storage):
    """The gradients summed as the kernel sums them (each CTA's partial over
    its tiles of its items, the partials in CTA order; each item's gLN means
    from the CTAs' partials in rank order) against one tensor sum each."""
    dskip, hb, st, canon, want = _residuals(storage)
    got = tcn_train_backward_plain(dskip, hb, st, *canon, dils=DILS8, storage=storage,
                                   ctas=ctas, groups=groups)
    bound = FP32_ORDER_REL if storage == torch.float32 else TRAIN_TRUNK_GRAD_REL
    for name, g, w in zip(("dh0", "dwe", "dwdw", "dwcat", "dvec"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        rows = [(f"dvec[{r}]", g[:, r], w[:, r]) for r in (0, 1, 2, 3, 4, 5, 6, 8, 9)] \
            if name == "dvec" else [(name, g, w)]
        for what, gp, wp in rows:
            assert _rel(gp, wp) <= bound, (what, _rel(gp, wp))
    assert not got[4][:, 7].any()


def test_default_order_is_the_plain_backward():
    dskip, hb, st, canon, want = _residuals(torch.bfloat16)
    again = tcn_train_backward_plain(dskip, hb, st, *canon, dils=DILS8)
    assert all(torch.equal(a, b) for a, b in zip(again, want))


def test_backward_reads_zero_beyond_short_items():
    """A dilation past the item's length (K = 50 under dilation 64): every tap
    outside [0, K) reads zero, as in the kernel's staging."""
    arrays, dskip = _inputs(3, 50, 16, 32, (1, 64, 2), seed=8)
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    _, hb, st = tcn_train_forward_plain(h0, *fold_canonical(*canon), dils=(1, 64, 2))
    got = tcn_train_backward_plain(torch.from_numpy(dskip), hb, st, *canon, dils=(1, 64, 2),
                                   ctas=1)
    assert got[0].shape == (3, 50, 16) and all(torch.isfinite(g).all() for g in got)


CB, CH = 16, 32
JAX_DILS = (1, 2, 4, 1, 2, 4)


@functools.lru_cache(maxsize=None)
def _against_jax():
    """The port's chain (plain forward, then the backward with the kernel's
    order for its plan) and JAX's tcn_trunk_train gradients in interpret mode,
    on the same inputs, the loss sum(out * probe): dskip = probe."""
    arrays, probe = _inputs(2, 130, CB, CH, JAX_DILS, seed=9)
    fn = functools.partial(jtrain.tcn_trunk_train, dils=JAX_DILS, taps=3, chunk=512,
                           interpret=True)

    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * probe)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    _, hb, st = tcn_train_forward_plain(h0, *fold_canonical(*canon), dils=JAX_DILS)
    plan = backward_plan(2, 130, CB, CH, 3, JAX_DILS, **H100)
    got = tcn_train_backward_plain(torch.from_numpy(probe), hb, st, *canon, dils=JAX_DILS,
                                   ctas=plan.ctas, groups=plan.groups)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


@pytest.mark.parametrize("name", ["dh0", "dwe", "dwdw", "dwcat", "dvec", "dalpha"])
def test_kernel_order_matches_jax_pallas_interpret(name):
    want, got = _against_jax()

    def view(g):
        return {"dh0": g[0], "dwe": g[1], "dwdw": g[2], "dwcat": g[3], "dvec": g[4][:, :7],
                "dalpha": g[4][:, 8:10].sum(-1)}[name]

    assert view(got).shape == view(want).shape
    assert _snr_db(view(want), view(got)) >= BF16_GRAD_DB, _snr_db(view(want), view(got))
