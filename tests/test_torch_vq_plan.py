"""PyTorch port: the launch plan of the nearest-code search kernel and its
grouped call, on the CPU.

``ops/vq_cuda.py::search_plan`` sizes ``csrc/nearest_code.cu``'s one persistent
launch a call from the card's SM count and shared memory: work units of 16
rows (resident: a row tile of every group; streamed: of one group,
group-major) dealt to the CTAs as contiguous ranges, which each CTA walks two
units at a time within a group. A plan is right when every (group, row) is
owned exactly once, when no CTA holds more than one unit above another, when
a CTA's shared memory fits, and when the codebook is resident exactly where
every group's fits. These tests check that arithmetic with an H100's figures,
the tiling constants and the ctypes signature against the source, the grouped
plain version against JAX's ``nearest_code_pallas`` (interpret mode) and XLA
path per group, and the port's ``ResidualVectorQuantizer``, one grouped search
a stage, against the JAX module. The kernel itself runs in
``test_torch_cuda.py`` on a GPU.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import vq as jvq
from speech_separation_tpu.ops.vq_pallas import nearest_code_pallas
from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.models import vq as vq_module
from speech_separation_tpu_torch.models.vq import ResidualVectorQuantizer
from speech_separation_tpu_torch.ops.vq_cuda import (
    MAX_DIM,
    SEARCH_CHUNK_CODES,
    SEARCH_CODE_WARPS,
    SEARCH_STEP_ROWS,
    SEARCH_STREAM_DIMS,
    SEARCH_THREADS,
    SEARCH_TILE_ROWS,
    nearest_code,
    nearest_code_plain,
    search_plan,
    search_smem_bytes,
)

# NVIDIA H100 SXM: 132 SMs, 227 KB of shared memory a block (opt-in), 228 KB an SM
H100 = {"sms": 132, "smem_optin": 232_448, "smem_per_sm": 233_472}
RESERVED = 1024  # the system's shared memory a CTA
CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
ROWS = [1, 15, 16, 17, 1000, 12_800, 51_200, 200_000]
DIMS = [1, 13, 16, 64, 256]
CODES = [1, 509, 512, 4096]
GROUPS = [1, 4, 8]
# A pick that differs from JAX's must be a near tie: the two codes' float64
# squared distances within 1e-5 of ‖x‖² + max ‖e‖² (fp32 dot products of <= 64
# terms, rounded in another order on each side).
NEAR_TIE_REL = 1e-5


def _walk(plan, cta: int) -> list[tuple[int, int]]:
    """The (first unit, units) steps CTA ``cta`` takes, as the kernel's loop
    takes them: two units where both lie in one group, else one."""
    units = plan.owned(cta)
    steps, u = [], units.start
    while u < units.stop:
        step = 2 if u + 1 < units.stop and (u + 1) // plan.tiles == u // plan.tiles else 1
        steps.append((u, step))
        u += step
    return steps


def _owners(plan, rows: int, groups: int) -> np.ndarray:
    """How many CTA steps own each (group, row)."""
    count = np.zeros((groups, plan.tiles * SEARCH_TILE_ROWS), dtype=np.int64)
    for cta in range(plan.ctas):
        for u, step in _walk(plan, cta):
            g, t = divmod(u, plan.tiles)
            rows_ = slice(t * SEARCH_TILE_ROWS, (t + step) * SEARCH_TILE_ROWS)
            if plan.resident:
                count[:, rows_] += 1  # a resident unit is a row tile of every group
            else:
                count[g, rows_] += 1
    return count[:, :rows]


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("codes", CODES)
@pytest.mark.parametrize("dim", DIMS)
def test_every_group_and_row_is_owned_once(dim, codes, groups):
    for rows in (1, 17, 1000, 12_800):
        plan = search_plan(rows, groups, dim, codes, **H100)
        assert plan.units == plan.tiles * (1 if plan.resident else groups)
        assert (_owners(plan, rows, groups) == 1).all()


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("groups", GROUPS)
def test_units_balance_to_one_unit_and_fit_the_card(rows, groups):
    for dim in DIMS:
        for codes in CODES:
            plan = search_plan(rows, groups, dim, codes, **H100)
            sizes = [len(plan.owned(c)) for c in range(plan.ctas)]
            assert sum(sizes) == plan.units and min(sizes) >= 1
            assert max(sizes) - min(sizes) <= 1  # no CTA a unit above another
            # CTA c on SM c % SMs: no SM more than one unit above the mean
            per_sm = np.bincount(np.arange(plan.ctas) % H100["sms"], weights=sizes)
            assert per_sm.max() - plan.units / min(plan.ctas, H100["sms"]) <= 1
            assert plan.ctas == min(plan.units, H100["sms"] * plan.ctas_per_sm)
            assert plan.smem <= H100["smem_optin"]
            assert plan.ctas_per_sm * (plan.smem + RESERVED) <= H100["smem_per_sm"]
            assert plan.ctas_per_sm == 1  # the kernel's __launch_bounds__ minimum


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("codes", CODES)
def test_resident_exactly_where_every_codebook_fits(codes, groups):
    for dim in DIMS:
        plan = search_plan(1000, groups, dim, codes, **H100)
        need = search_smem_bytes(dim, codes, groups, True)
        fits = need <= H100["smem_optin"] and need + RESERVED <= H100["smem_per_sm"]
        assert plan.resident == fits
        assert plan.smem == search_smem_bytes(dim, codes, groups, plan.resident)
        # the codebooks take every group's [S][K] padded to whole 512-code chunks
        kpad = -(-codes // SEARCH_CHUNK_CODES) * SEARCH_CHUNK_CODES
        assert need >= 4 * groups * dim * kpad


def test_the_codec_shapes_are_resident_and_the_largest_stream():
    deep = search_plan(12_800, 1, 64, 512, **H100)
    assert deep.resident and (deep.ctas, deep.units) == (132, 800)
    assert {len(deep.owned(c)) for c in range(132)} == {6, 7}  # was 200 blocks of 64 rows
    stage = search_plan(51_200, 4, 16, 512, **H100)  # one skip stage, 4 groups, one launch
    assert stage.resident and (stage.ctas, stage.units) == (132, 3200)
    assert {len(stage.owned(c)) for c in range(132)} == {24, 25}
    assert not search_plan(700, 1, 256, 1024, **H100).resident
    assert not search_plan(1000, 1, MAX_DIM, 4096, **H100).resident
    assert search_plan(0, 4, 16, 512, **H100).units == 0


def test_out_of_range_shapes_raise():
    for rows, groups, dim, codes in ((10, 1, 0, 8), (10, 1, MAX_DIM + 1, 8), (10, 1, 16, 0),
                                     (10, 0, 16, 8), (-1, 1, 16, 8)):
        with pytest.raises(ValueError, match="nearest_code"):
            search_plan(rows, groups, dim, codes, **H100)
    with pytest.raises(ValueError, match="shared memory"):
        search_plan(10, 1, 16, 8, **dict(H100, smem_optin=40_000))


def test_tiling_constants_match_the_kernel_source():
    text = (CSRC / "nearest_code.cu").read_text()
    # the one -D switch is the probe's, and the port builds it off
    assert re.findall(r"#define (SST_VQ_\w+) (\d+)", text) == [("SST_VQ_SKIP", "0")]
    found = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert (found["kThreads"], found["kRows"], found["kCodes"], found["kRowLanes"],
            found["kChunkCodes"], found["kStreamDims"], found["kMaxDim"]) == (
        SEARCH_THREADS, 8, 8, 4, SEARCH_CHUNK_CODES, SEARCH_STREAM_DIMS, MAX_DIM)
    # 8 warps along a chunk's codes (8 codes a lane x 8 lanes each), so a full
    # step is 8 rows a thread x 4 row lanes: two 16-row units
    rows, codes, row_lanes = found["kRows"], found["kCodes"], found["kRowLanes"]
    code_warps = SEARCH_CHUNK_CODES // (codes * (32 // row_lanes))
    assert code_warps == SEARCH_CODE_WARPS == 8
    assert rows * row_lanes * (SEARCH_THREADS // 32 // code_warps) == SEARCH_STEP_ROWS == 32
    assert SEARCH_TILE_ROWS == SEARCH_STEP_ROWS // 2 == 16
    assert "__launch_bounds__(kThreads, 1)" in text


def test_ctypes_signature_matches_the_c_declaration():
    text = (CSRC / "nearest_code.cu").read_text()
    (params,) = re.findall(r'extern "C" int sst_nearest_code\(([^)]*)\)', text)
    want = tuple(_build._P if "*" in p else _build._I for p in params.split(",") if p.strip())
    assert _build._SIGNATURES["sst_nearest_code"] == want
    assert len(want) == 12  # flat, codebook, out, rows, ld, groups, dim, codes, ctas, resident, smem, stream


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _near_tie_picks(flat, codebook, got, want) -> int:
    """Rows where ``got`` and ``want`` differ, each asserted to be a near tie."""
    rows = np.nonzero(got != want)[0]
    x, e = flat[rows].astype(np.float64), codebook.astype(np.float64)
    d_got = ((x - e[:, got[rows]].T) ** 2).sum(1)
    d_want = ((x - e[:, want[rows]].T) ** 2).sum(1)
    scale = (x**2).sum(1) + (e**2).sum(0).max()
    assert np.all(np.abs(d_got - d_want) <= NEAR_TIE_REL * scale), rows
    return len(rows)


@pytest.mark.parametrize("n,g,s,k", [(600, 4, 16, 512), (257, 2, 64, 128), (129, 3, 13, 65),
                                     (40, 8, 8, 33)])
def test_grouped_plain_matches_jax_per_group(n, g, s, k):
    flat = _normal((n, g * s), 60 + g)
    codebook = _normal((g, s, k), 70 + g)
    got = nearest_code_plain(torch.from_numpy(flat), torch.from_numpy(codebook))
    assert got.dtype == torch.int32 and got.shape == (n, g)
    # the CPU wrapper takes the grouped plain version, and a strided view of
    # wider rows gives the same picks
    wide = np.concatenate([_normal((n, 5), 80), flat], axis=1)
    assert torch.equal(nearest_code(torch.from_numpy(wide)[:, 5:], torch.from_numpy(codebook)), got)
    differing = 0
    for j in range(g):
        x, e = flat[:, j * s:(j + 1) * s], codebook[j]
        for jax_fn in (nearest_code_pallas, jvq.nearest_code_indices):  # Pallas interprets here
            want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(e)))
            differing += _near_tie_picks(x, e, got[:, j].numpy(), want)
        # each group is the 2-D search of its columns, bit for bit
        np.testing.assert_array_equal(
            got[:, j].numpy(), nearest_code_plain(torch.from_numpy(x), torch.from_numpy(e)).numpy())
    assert differing <= max(2, n * g // 100)


@pytest.mark.parametrize("pq", [1, 2, 4])
def test_residual_vector_quantizer_makes_one_grouped_search_a_stage(pq, monkeypatch):
    kw = dict(num_embeddings=96, embedding_dim=32, depth=3, pq=pq)
    x = _normal((4, 75, 32), 90 + pq, 0.7)
    jmodule = jvq.ResidualVectorQuantizer(**kw)
    params = jax.tree.map(np.asarray, jmodule.init(jax.random.key(pq), jnp.asarray(x))["params"])
    module = ResidualVectorQuantizer(**kw)
    with torch.no_grad():
        module.embeddings.copy_(torch.from_numpy(np.array(params["embeddings"])))
    calls = []

    def counted(flat, codebook):
        calls.append((tuple(flat.shape), tuple(codebook.shape), flat.stride()))
        return nearest_code(flat, codebook)

    monkeypatch.setattr(vq_module, "nearest_code", counted)
    with torch.no_grad():
        codes = module.codes(torch.from_numpy(x))
        out, _ = module(torch.from_numpy(x))
    # one call a stage, every group in it, the residual read in place
    assert calls == [((300, 32), (pq, 32 // pq, 96), (32, 1))] * 6
    jcodes = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x), method="codes"))
    jout, _ = jmodule.apply({"params": params}, jnp.asarray(x))
    assert codes.shape == jcodes.shape == (4, 75, 3 * pq) and codes.dtype == torch.int32
    got, want = codes.numpy().reshape(-1, 3 * pq), jcodes.reshape(-1, 3 * pq)
    # a differing code must be a near tie given the same earlier stages
    residual, sub = x.reshape(-1, 32).astype(np.float32), 32 // pq
    emb = np.asarray(params["embeddings"])
    for d in range(3):
        agree = (got[:, : d * pq] == want[:, : d * pq]).all(1)
        for j in range(pq):
            col = d * pq + j
            _near_tie_picks(residual[agree, j * sub:(j + 1) * sub], emb[d, j], got[agree, col],
                            want[agree, col])
        residual = residual - np.concatenate([emb[d, j].T[got[:, d * pq + j]] for j in range(pq)], 1)
    assert (got != want).mean() <= 0.01
    if (got == want).all():
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
