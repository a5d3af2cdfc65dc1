"""PyTorch port, CUDA kernels against their plain versions on a GPU.

Every test here is marked ``cuda`` and skips where there is no GPU. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.ops.lstm_cuda import (
    _forward_launch,
    forward_plan,
    lstm_recurrence,
    lstm_recurrence_plain,
)
from speech_separation_tpu_torch.ops.lstm_train_cuda import (
    _backward_launch,
    backward_plan,
    bilstm_reference,
    bilstm_train,
    lstm_train_backward,
    lstm_train_backward_plain,
    lstm_train_forward,
    lstm_train_forward_plain,
)
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.vq import ResidualVectorQuantizer, VectorQuantizer
from speech_separation_tpu_torch.models.vqvae import VqVaeT3Tok
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply
from speech_separation_tpu_torch.ops.stft import stft
from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda, stft_fft_plain
from speech_separation_tpu_torch.ops.tcn_cuda import (
    _device_limits,
    fold_canonical,
    tcn_trunk_cuda,
    tcn_trunk_plain,
    trunk_plan,
    trunk_reference,
)
from speech_separation_tpu_torch.ops.tcn_train_cuda import (
    TRUNK_BWD_LAPS,
    launch_backward,
    tcn_train_backward,
    tcn_train_backward_plain,
    tcn_train_forward,
    tcn_train_forward_plain,
    tcn_trunk_train,
    trunk_backward_phase_ms,
)
from speech_separation_tpu_torch.ops.tcn_train_cuda import backward_plan as tcn_backward_plan
from speech_separation_tpu_torch.ops.vq_cuda import nearest_code, nearest_code_plain
from speech_separation_tpu_torch.separate.pipeline import make_separate_fn

pytestmark = pytest.mark.cuda

STFT_ATOL = 1e-4  # the real FFT against the fp32 DFT product and torch.fft, sums in other orders
LSTM_ATOL = 1e-4  # fp32 kernel against the fp32 plain loop
LSTM_BF16_ATOL = 3e-2  # bf16 operands, fp32 carry, against the fp32 plain loop
PATH_REL = 1e-4  # relative L2 of the fp32 separation output
# Training kernels against their plain versions on the same inputs. fp32: the
# same operations, sums in another order. bf16: both round gates, h and
# dgates to bf16 (8-bit mantissa) at the same places, so they differ only
# where a sum's last bit flips a bf16 rounding, by one bf16 ulp of values
# below 1 (3.9e-3 at 0.5 to 1), carried through a few steps: the bound of
# the serving kernel's bf16 check.
TRAIN_ATOL = 1e-4
TRAIN_BF16_ATOL = 3e-2
GRAD_REL = 1e-4  # relative L2 of bilstm_train's fp32 gradients against autograd
# The trunk kernel against its plain version: both store h, skip, t1 and t2 in
# bf16 at the same places; a sum taken in another order can flip one bf16
# rounding (2^-8 relative), which later blocks carry, so the bound is 3e-2 of
# the largest |skip| (at least 1).
TRUNK_BF16_REL = 3e-2
SERVE_KERNEL_DB = 30.0  # cuda_apply, kernel trunk against plain trunk, both bf16
# The nearest-code kernel against its plain version (cuBLAS fp32, TF32 off):
# both fp32, dot products summed in another order, so a pick may differ only
# where the two codes' float64 distances are within 1e-5 of ‖x‖² + ‖e‖²; on
# inputs exact in fp32 (multiples of 1/32) every index is equal.
NEAR_TIE_REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _normal(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(16, 64000), (3, 4097), (12345,)])
def test_stft_kernel_matches_plain(cuda_device, shape):
    x = _normal(shape, seed=0).to(cuda_device)
    before = stft_cuda.launches
    got = stft_cuda(x)
    torch.cuda.synchronize()
    assert stft_cuda.launches == before + 1
    want = stft(x)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= STFT_ATOL
    # the FFT oracle is an independent computation of the same spectrum
    assert (got - stft(x, method="fft")).abs().max().item() <= STFT_ATOL


@pytest.mark.parametrize("size", [64, 256, 1024])
def test_stft_kernel_sizes_without_fading(cuda_device, size):
    x = _normal((5, 20011), seed=15).to(cuda_device)
    got = stft_cuda(x, size, size // 2, fading=False)
    torch.cuda.synchronize()
    # a view of the kernel's interleaved [B, F, bins, 2] buffer, not a copy
    assert got._base is not None and got._base.dtype == torch.float32
    assert got._base.shape == (*got.shape, 2) and got.data_ptr() == got._base.data_ptr()
    for want in (stft(x, size, size // 2, fading=False),
                 stft(x, size, size // 2, fading=False, method="fft"),
                 stft_fft_plain(x, size, size // 2, fading=False)):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= STFT_ATOL


def test_stft_kernel_raises_on_other_sizes(cuda_device):
    x = _normal((2, 4000), seed=16).to(cuda_device)
    before = stft_cuda.launches
    with pytest.raises(ValueError, match="size 320"):
        stft_cuda(x, 320, 160)
    with pytest.raises(ValueError, match="size 2048"):
        stft_cuda(x, 2048, 1024)
    assert stft_cuda.launches == before


@pytest.mark.parametrize("dtype,atol", [(torch.float32, LSTM_ATOL), (torch.bfloat16, LSTM_BF16_ATOL)])
def test_lstm_kernel_matches_plain(cuda_device, dtype, atol):
    xw = _normal((2, 37, 70, 4 * 40), seed=1).to(cuda_device)
    u = (_normal((2, 40, 160), seed=2) / np.sqrt(40)).to(cuda_device)
    for reverse in [(False, True), (True, False)]:
        want = lstm_recurrence_plain(xw, u, reverse=reverse)
        got = lstm_recurrence(xw, u, reverse=reverse, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (37, 70, 80)
        assert (got.float() - want).abs().max().item() <= atol
    single = lstm_recurrence(xw[1:], u[1:], reverse=(True,))
    want = lstm_recurrence_plain(xw[1:], u[1:], reverse=(True,))
    assert (single - want).abs().max().item() <= LSTM_ATOL


def _bound(atol, dtype, want):
    """fp32: ``atol``; bf16: ``atol`` of the largest magnitude (at least 1)."""
    if dtype == torch.float32:
        return atol
    return atol * max(1.0, max(w.float().abs().max().item() for w in want))


@pytest.mark.parametrize("dtype,atol", [(torch.float32, LSTM_ATOL), (torch.bfloat16, LSTM_BF16_ATOL)])
@pytest.mark.parametrize("dirs,batch,steps,hidden", [
    (2, 32, 40, 496), (2, 256, 24, 496),  # the training and serving widths
    (2, 300, 12, 496),  # two row slices, two launches a call
    (1, 16, 40, 496), (2, 3, 37, 20), (2, 5, 19, 21),  # D = 1; ragged B and H (unaligned rows)
    (2, 40, 8, 1024),  # fp32 reads U through L1 from L2
    (2, 256, 16, 256),  # fp32: 4 groups a block, two a pass
])
def test_lstm_forward_kernels_match_plain(cuda_device, dtype, atol, dirs, batch, steps, hidden):
    """The persistent forward, serving and training modes: within the plain
    version's bound, one launch a call per row slice, reruns bit-identical."""
    xw, u, k = _train_inputs(dirs, batch, steps, hidden, cuda_device, seed=31, keep=dirs == 2)
    slices = -(-batch // 256)
    for reverse in ([(False, True), (True, False)] if dirs == 2 else [(True,), (False,)]):
        before = lstm_recurrence.launches
        got = lstm_recurrence(xw, u, reverse=reverse, compute_dtype=dtype)
        again = lstm_recurrence(xw, u, reverse=reverse, compute_dtype=dtype)
        want = lstm_recurrence_plain(xw, u, reverse=reverse, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert lstm_recurrence.launches == before + 2 * slices
        assert torch.equal(got, again)
        assert (got.float() - want.float()).abs().max().item() <= _bound(atol, dtype, [want])
    if dirs == 1:
        return
    for keep in (None, k):
        before = lstm_train_forward.launches
        got = lstm_train_forward(xw, u, keep=keep, compute_dtype=dtype)
        again = lstm_train_forward(xw, u, keep=keep, compute_dtype=dtype)
        want = lstm_train_forward_plain(xw, u, keep=keep, compute_dtype=dtype)
        torch.cuda.synchronize()
        assert lstm_train_forward.launches == before + 2 * slices
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        bound = _bound(atol, dtype, want)
        for g, w, name in zip(got, want, ("out", "gates", "c_all")):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            assert (g.float() - w.float()).abs().max().item() <= bound, name


@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
def test_lstm_train_forward_at_the_training_bench_shape(cuda_device, dtype, atol):
    """B = 32 at H = 496 over T = 501 steps, the training bench's shape: the
    only one whose plan is one group a block over two row blocks, through
    every step of a real utterance."""
    xw, u, _ = _train_inputs(2, 32, 501, 496, cuda_device, seed=34, keep=False)
    before = lstm_train_forward.launches
    got = lstm_train_forward(xw, u, compute_dtype=dtype)
    again = lstm_train_forward(xw, u, compute_dtype=dtype)
    want = lstm_train_forward_plain(xw, u, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert lstm_train_forward.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    bound = _bound(atol, dtype, want)
    for g, w, name in zip(got, want, ("out", "gates", "c_all")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert (g.float() - w.float()).abs().max().item() <= bound, name


def test_lstm_forward_refused_launch_raises(cuda_device):
    batch, hidden = 256, 496
    xw, u, _ = _train_inputs(2, batch, 3, hidden, cuda_device, seed=33, keep=False)
    plan = forward_plan(batch, hidden, False, 2, sms=132, smem_optin=232448, smem_per_sm=233472)
    # one group a block: 2 x 16 x 31 blocks, more than the card holds at once
    too_large = dataclasses.replace(plan, groups=1, row_blocks=16)
    out = torch.empty(batch, 3, 2 * hidden, device=cuda_device)
    before = lstm_recurrence.launches
    with pytest.raises(RuntimeError, match="lstm_recurrence: CUDA error"):
        _forward_launch(lstm_recurrence, xw, u, out, 0b10, too_large)
    assert lstm_recurrence.launches == before
    wide = 1100  # above the kernel's H <= 1024
    with pytest.raises(ValueError, match="H=1100"):
        lstm_recurrence(torch.zeros(2, 2, 3, 4 * wide, device=cuda_device),
                        torch.zeros(2, wide, 4 * wide, device=cuda_device), reverse=(False, True))
    with pytest.raises(ValueError, match="H=1100"):
        lstm_train_forward(torch.zeros(2, 2, 3, 4 * wide, device=cuda_device),
                           torch.zeros(2, wide, 4 * wide, device=cuda_device))


def test_model_kernel_path_matches_plain(cuda_device):
    model = UPitBlstm(hidden=40, num_layers=2, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda_device).eval()
    mag = _normal((3, 50, 129), seed=3).abs().to(cuda_device)
    with torch.no_grad():
        got = model(mag)
        want = model(mag, plain=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def test_separate_kernel_path_matches_plain(cuda_device, tmp_path):
    root = make_synthetic_fixture(tmp_path, utterances_per_split=2, min_seconds=0.5, max_seconds=1.5)
    batch = next(iter(WaveformLoader(pathlib.Path(root) / "tt", batch_size=2)))
    model = UPitBlstm(hidden=40, num_layers=2, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda_device)
    mix = torch.from_numpy(batch.mix).to(cuda_device)
    lens = torch.from_numpy(batch.frame_lengths).to(cuda_device)
    got = make_separate_fn(model)(mix, lens)
    want = make_separate_fn(model, plain=True)(mix, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= PATH_REL


def _train_inputs(dirs, batch, steps, hidden, device, seed, keep):
    xw = _normal((dirs, batch, steps, 4 * hidden), seed).to(device)
    u = (_normal((dirs, hidden, 4 * hidden), seed + 1) / np.sqrt(hidden)).to(device)
    k = None
    if keep:  # segment breaks every few steps, in each direction's scan order
        k = torch.from_numpy(
            (np.random.default_rng(seed + 2).random((dirs, batch, steps)) > 0.2).astype(np.float32)
        ).to(device)
    return xw, u, k


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
@pytest.mark.parametrize("batch,steps,hidden", [(3, 37, 20), (33, 29, 40)])  # ragged B, T, H
def test_lstm_train_kernels_match_plain(cuda_device, keep, dtype, atol, batch, steps, hidden):
    xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=4, keep=keep)
    before = (lstm_train_forward.launches, lstm_train_backward.launches)
    want = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dtype)
    got = lstm_train_forward(xw, u, keep=k, compute_dtype=dtype)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("out", "gates", "c_all")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert (g.float() - w.float()).abs().max().item() <= atol, name
    _, gates, c_all = want
    dy = _normal((batch, steps, 2 * hidden), seed=7).to(cuda_device).to(dtype)
    want_dg = lstm_train_backward_plain(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    got_dg = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert got_dg.dtype == dtype and got_dg.shape == (2, batch, steps, 4 * hidden)
    assert (got_dg.float() - want_dg.float()).abs().max().item() <= atol
    assert (lstm_train_forward.launches, lstm_train_backward.launches) == (
        before[0] + 1, before[1] + 1,
    )


@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
@pytest.mark.parametrize("batch", [32, 64])  # the bench's rows; two row blocks
def test_lstm_train_backward_full_width(cuda_device, dtype, atol, batch):
    """The persistent kernel at H = 496, T = 64: one launch a call, reruns
    bit-identical, within the plain version's bound."""
    xw, u, _ = _train_inputs(2, batch, 64, 496, cuda_device, seed=17, keep=False)
    _, gates, c_all = lstm_train_forward_plain(xw, u, compute_dtype=dtype)
    dy = _normal((batch, 64, 2 * 496), seed=18).to(cuda_device).to(dtype)
    before = lstm_train_backward.launches
    got = lstm_train_backward(gates, c_all, dy, u, compute_dtype=dtype)
    again = lstm_train_backward(gates, c_all, dy, u, compute_dtype=dtype)
    want = lstm_train_backward_plain(gates, c_all, dy, u, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert lstm_train_backward.launches == before + 2
    assert torch.equal(got, again)
    bound = atol if dtype == torch.float32 else atol * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
@pytest.mark.parametrize("batch,steps,hidden", [(5, 9, 21), (2, 7, 1), (256, 20, 1024), (256, 60, 496)])
def test_lstm_train_backward_edge_shapes(cuda_device, keep, dtype, atol, batch, steps, hidden):
    """Odd H (bf16 rows only 8-byte aligned), a single unit, and B = 256 at
    the widest H and at the bench's: within the plain version's bound, and a
    rerun bit-identical."""
    xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=23, keep=keep)
    _, gates, c_all = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dtype)
    dy = _normal((batch, steps, 2 * hidden), seed=24).to(cuda_device).to(dtype)
    got = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    again = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    want = lstm_train_backward_plain(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    bound = atol if dtype == torch.float32 else atol * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound


@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
def test_lstm_train_backward_widest_hidden(cuda_device, dtype, atol):
    """H = 1024, the widest the plan takes: fp32 streams U's slice from L2
    beside the dgates chunks; bf16 keeps it resident. B = 40: three groups of
    16 rows a block, the last ragged."""
    batch, steps, hidden = 40, 6, 1024
    plan = backward_plan(batch, hidden, dtype == torch.bfloat16, sms=132, smem_optin=232448,
                         smem_per_sm=233472)
    assert plan.resident == (dtype == torch.bfloat16) and plan.groups == 3
    xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=21, keep=True)
    _, gates, c_all = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dtype)
    dy = _normal((batch, steps, 2 * hidden), seed=22).to(cuda_device).to(dtype)
    got = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    want = lstm_train_backward_plain(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    torch.cuda.synchronize()
    bound = atol if dtype == torch.float32 else atol * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound


def test_lstm_train_backward_refused_launch_raises(cuda_device):
    batch, hidden = 256, 496
    xw, u, _ = _train_inputs(2, batch, 3, hidden, cuda_device, seed=19, keep=False)
    _, gates, c_all = lstm_train_forward_plain(xw, u)
    dy = _normal((batch, 3, 2 * hidden), seed=20).to(cuda_device)
    plan = backward_plan(batch, hidden, False, sms=132, smem_optin=232448, smem_per_sm=233472)
    # one group a block: 2 x 16 x 31 blocks, more than the card holds at once
    too_large = dataclasses.replace(plan, groups=1, row_blocks=16)
    before = lstm_train_backward.launches
    with pytest.raises(RuntimeError, match="lstm_train_backward: CUDA error"):
        _backward_launch(gates, c_all, dy, u, None, torch.empty_like(gates), too_large)
    assert lstm_train_backward.launches == before
    wide = 1100  # above the kernel's H <= 1024
    with pytest.raises(ValueError, match="H=1100"):
        lstm_train_backward(torch.zeros(2, 2, 3, 4 * wide, device=cuda_device),
                            torch.zeros(2, 2, 3, wide, device=cuda_device),
                            torch.zeros(2, 3, 2 * wide, device=cuda_device),
                            torch.zeros(2, wide, 4 * wide, device=cuda_device))


@pytest.mark.parametrize("keep", [False, True])
def test_bilstm_train_grads_match_autograd(cuda_device, keep):
    b, t, f, h = 5, 23, 12, 20
    x = (_normal((b, t, f), seed=8) * 0.5).to(cuda_device)
    kernel = (_normal((2, f, 4 * h), seed=9) * 0.3).to(cuda_device)
    rec = (_normal((2, h, 4 * h), seed=10) * 0.3).to(cuda_device)
    bias = (_normal((2, 4 * h), seed=11) * 0.1).to(cuda_device)
    _, _, k = _train_inputs(2, b, t, h, cuda_device, seed=12, keep=keep)
    w = _normal((b, t, 2 * h), seed=13).to(cuda_device)
    grads = []
    for run in (
        lambda *a: bilstm_train(*a, keep=k, compute_dtype=torch.float32),
        lambda *a: bilstm_reference(*a, keep=k),
    ):
        params = [p.clone().requires_grad_() for p in (x, kernel, rec, bias)]
        (run(*params) * w).sum().backward()
        grads.append([p.grad for p in params])
    for got, want in zip(*grads):
        assert ((got - want).norm() / want.norm()).item() <= GRAD_REL


def test_train_step_kernel_path_matches_plain(cuda_device):
    from speech_separation_tpu_torch import train

    sources = (_normal((2, 2, 6000), seed=14) * 0.1).to(cuda_device)
    lengths = torch.tensor([48, 40], dtype=torch.int32, device=cuda_device)
    arrays = (sources.sum(dim=1), sources, lengths)
    losses, params = {}, {}
    for kind in ("kernel", "plain"):
        model = UPitBlstm(hidden=40, num_layers=2, dropout_rate=0.0,
                          generator=torch.Generator().manual_seed(0)).to(cuda_device)
        state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
        before = (lstm_train_forward.launches, lstm_train_backward.launches)
        train_step, eval_step = train.make_upit_waveform_steps(model, plain=kind == "plain")
        losses[kind] = [train_step(state, *arrays)[1].item() for _ in range(3)]
        losses[kind].append(eval_step(state, *arrays).item())
        launched = (lstm_train_forward.launches - before[0], lstm_train_backward.launches - before[1])
        assert launched == ((2 * 4, 2 * 3) if kind == "kernel" else (0, 0))
        params[kind] = torch.cat([p.detach().flatten() for p in model.parameters()])
    np.testing.assert_allclose(losses["kernel"], losses["plain"], rtol=1e-5)
    assert ((params["kernel"] - params["plain"]).norm() / params["plain"].norm()).item() <= 1e-4


def test_packed_train_step_kernel_path_matches_plain(cuda_device, tmp_path):
    """A packed batch (4 rows, H = 64): the kernel path's loss and gradients,
    with both recurrences in their keep mode, equal the plain loops'; its
    steps too; and its loss is the sum of each utterance's loss run alone."""
    from speech_separation_tpu_torch import train
    from speech_separation_tpu_torch.data.packing import PackedWaveformLoader
    from speech_separation_tpu_torch.losses.pit import pit_loss_packed
    from speech_separation_tpu_torch.ops.features import psm_features

    root = make_synthetic_fixture(tmp_path / "fx", utterances_per_split={"tr": 1, "cv": 1, "tt": 9},
                                  min_seconds=0.5, max_seconds=1.5)
    loader = PackedWaveformLoader(root / "tt", rows_per_batch=4, row_seconds=2.5)
    b = next(iter(loader))
    assert b.mix.shape[0] == 4 and b.frame_seg.max() >= 1  # rows of several utterances
    mix, sources, seg = (torch.from_numpy(a).to(cuda_device) for a in (b.mix, b.sources, b.frame_seg))
    losses, grads, params = {}, {}, {}
    for kind in ("kernel", "plain"):
        plain = kind == "plain"
        model = UPitBlstm(hidden=64, num_layers=2, dropout_rate=0.0,
                          generator=torch.Generator().manual_seed(0)).to(cuda_device)
        before = (lstm_train_forward.keep_launches, lstm_train_backward.keep_launches)
        feats = psm_features(mix, sources, plain=plain)
        preds = model.train_forward(feats.magnitude, segment_ids=seg, plain=plain)
        loss = pit_loss_packed(preds, feats.labels, seg, num_segments=loader.num_segments)
        loss.backward()
        launched = (lstm_train_forward.keep_launches - before[0],
                    lstm_train_backward.keep_launches - before[1])
        assert launched == ((2, 2) if kind == "kernel" else (0, 0))  # one a layer
        grads[kind] = [p.grad.detach().clone() for p in model.parameters()]
        state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
        train_step, eval_step = train.make_upit_packed_steps(
            model, num_segments=loader.num_segments, plain=plain)
        losses[kind] = [loss.item()] + [train_step(state, mix, sources, seg)[1].item()
                                        for _ in range(2)] + [eval_step(state, mix, sources, seg).item()]
        params[kind] = torch.cat([p.detach().flatten() for p in model.parameters()])
    np.testing.assert_allclose(losses["kernel"], losses["plain"], rtol=1e-5)
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert ((got - want).norm() / want.norm()).item() <= 1e-4
    assert ((params["kernel"] - params["plain"]).norm() / params["plain"].norm()).item() <= 1e-4

    # the kernel path's packed loss is the sum of each utterance's loss alone
    model = UPitBlstm(hidden=64, num_layers=2, dropout_rate=0.0,
                      generator=torch.Generator().manual_seed(0)).to(cuda_device)
    state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
    _, eval_packed = train.make_upit_packed_steps(model, num_segments=loader.num_segments)
    _, eval_single = train.make_upit_waveform_steps(model)
    singles = {}
    for one in WaveformLoader(root / "tt", batch_size=1, pad_quantum_samples=1):  # unpadded
        args = (torch.from_numpy(a).to(cuda_device) for a in (one.mix, one.sources, one.frame_lengths))
        singles[one.names[0]] = eval_single(state, *args).item()
    want = sum(singles[n] for row in b.names for n in row)
    np.testing.assert_allclose(eval_packed(state, mix, sources, seg).item(), want, rtol=1e-4)


def _trunk_inputs(batch, frames, cb, ch, dils, device, seed):
    n = len(dils)
    vecs = _normal((n, 8, max(ch, 2 * cb)), seed) * 0.1
    vecs[:, 1] += 1.0  # norm1 gamma near 1
    vecs[:, 6], vecs[:, 7] = 0.25, 0.2  # PReLU slopes
    return (
        _normal((batch, frames, cb), seed + 1).to(device),
        (_normal((n, cb, ch), seed + 2) / np.sqrt(cb)).to(device, torch.bfloat16),
        (_normal((n, 3, ch), seed + 3) / np.sqrt(3)).to(device),
        (_normal((n, ch, 2 * cb), seed + 4) / np.sqrt(ch)).to(device, torch.bfloat16),
        vecs.to(device),
    )


@pytest.mark.parametrize("frames", [130, 1100, 4003])  # ragged: no multiple of a 128-frame tile
@pytest.mark.parametrize("cb,ch", [(32, 48), (128, 256)])
def test_tcn_trunk_kernel_matches_plain(cuda_device, frames, cb, ch):
    dils = (1, 2, 4, 8, 16, 32, 64, 1)
    inputs = _trunk_inputs(2, frames, cb, ch, dils, cuda_device, seed=20)
    before = tcn_trunk_cuda.launches
    got = tcn_trunk_cuda(*inputs, dils=dils)
    again = tcn_trunk_cuda(*inputs, dils=dils)
    want = tcn_trunk_plain(*inputs, dils=dils)
    torch.cuda.synchronize()
    assert tcn_trunk_cuda.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, frames, cb)
    assert torch.equal(got, again)  # fixed-order statistics: bit-identical reruns
    bound = TRUNK_BF16_REL * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= bound


def _check_trunk_kernel(inputs, dils):
    """The trunk kernel and the training forward against the plain trunk:
    within the bound, reruns bit-identical, one launch a call, the training
    forward's skip the serving kernel's bit for bit. Each block's saved
    statistics are held to the plain block run on the kernel's own saved
    input of that block: at short K a gLN group is a few hundred values, and
    the plain chain's inputs, carried through other bf16 roundings, move its
    statistics by more than their fp32 noise."""
    h0, we, wdw, wg, vecs = inputs
    before = (tcn_trunk_cuda.launches, tcn_train_forward.launches)
    got = tcn_trunk_cuda(*inputs, dils=dils)
    again = tcn_trunk_cuda(*inputs, dils=dils)
    skip, hb, st = tcn_train_forward(*inputs, dils=dils)
    want = tcn_train_forward_plain(*inputs, dils=dils)
    torch.cuda.synchronize()
    assert (tcn_trunk_cuda.launches - before[0], tcn_train_forward.launches - before[1]) == (2, 1)
    assert torch.equal(got, again) and torch.equal(skip, got)
    for g, w in zip((got, hb), want[:2]):
        bound = TRUNK_BF16_REL * max(1.0, w.float().abs().max().item())
        assert g.shape == w.shape and (g.float() - w.float()).abs().max().item() <= bound
    block_st = torch.cat([
        tcn_train_forward_plain(hb[j], we[j:j + 1], wdw[j:j + 1], wg[j:j + 1], vecs[j:j + 1],
                                dils=dils[j:j + 1])[2]
        for j in range(len(dils))
    ])
    for col in range(4):  # mu1, 1/sigma1, mu2, 1/sigma2
        assert _rel(st[..., col], block_st[..., col]) <= TRAIN_TRUNK_STATS_REL, col


@pytest.mark.parametrize("cb,ch", [(32, 48), (128, 256)])
def test_tcn_trunk_kernel_batch_past_the_items_in_flight(cuda_device, cb, ch):
    """More items than the plan keeps in flight: each group walks several."""
    dils = (1, 2, 4, 8, 16, 32, 64, 1)
    props = torch.cuda.get_device_properties(cuda_device)
    limits = dict(sms=props.multi_processor_count, smem_optin=props.shared_memory_per_block_optin,
                  smem_per_sm=props.shared_memory_per_multiprocessor, l2_bytes=props.L2_cache_size)
    batch = 2 * trunk_plan(64, 3000, cb, ch, 3, dils, **limits).groups + 1
    assert -(-batch // trunk_plan(batch, 3000, cb, ch, 3, dils, **limits).groups) >= 2
    _check_trunk_kernel(_trunk_inputs(batch, 3000, cb, ch, dils, cuda_device, seed=21), dils)


@pytest.mark.parametrize("frames", [1, 40, 63])
def test_tcn_trunk_kernel_dilation_64_on_short_items(cuda_device, frames):
    """K below the largest dilation's halo: every tap of the dilation-64 blocks
    but the centre reads the zero padding."""
    dils = (1, 64, 2, 64, 32)
    _check_trunk_kernel(_trunk_inputs(3, frames, 32, 48, dils, cuda_device, seed=22), dils)


def test_tcn_trunk_kernel_raises(cuda_device):
    dils = (1, 2, 4, 8, 16, 32, 64, 1)
    h0, we, wdw, wg, vecs = _trunk_inputs(1, 100, 32, 48, dils, cuda_device, seed=30)
    with pytest.raises(ValueError, match="dilations"):
        tcn_trunk_cuda(h0, we, wdw, wg, vecs, dils=dils[:-1] + (128,))
    with pytest.raises(ValueError, match="multiples of 8"):
        tcn_trunk_cuda(h0[..., :-4], we[:, :-4], wdw, wg[..., :-8], vecs, dils=dils)
    with pytest.raises(ValueError, match="tensors on"):
        tcn_trunk_cuda(h0, we.cpu(), wdw, wg, vecs, dils=dils)


def test_cuda_apply_kernel_trunk_matches_plain_trunk(cuda_device):
    model = ConvTasNet(enc_dim=64, bottleneck=32, hidden=48, blocks=4, repeats=2,
                       generator=torch.Generator().manual_seed(0)).to(cuda_device)
    mix = (_normal((3, 8800), seed=40) * 0.3).to(cuda_device)  # K = 1100 frames
    before = tcn_trunk_cuda.launches
    got = cuda_apply(model, mix)
    want = cuda_apply(model, mix, plain=True)
    torch.cuda.synchronize()
    assert tcn_trunk_cuda.launches == before + 1
    assert got.shape == (3, 2, 8800) and torch.isfinite(got).all()
    snr = 10 * torch.log10(want.square().sum() / (got - want).square().sum().clamp_min(1e-30))
    assert snr.item() >= SERVE_KERNEL_DB


# The training trunk kernels against their plain versions (both bf16). The
# forward is the serving kernel with residual stores: its skip equals
# tcn_trunk_cuda's bit for bit, and like it, it differs from the plain version
# by carried one-ulp bf16 flips (TRUNK_BF16_REL). The backward rounds seven
# slabs to bf16 and sums over (K, ch) in another order than the plain
# version; a flip there moves a gradient by one bf16 ulp of its summands
# (2^-8), which is within 3e-2 of each gradient's L2 norm, and of each used
# row of dvec on its own (the rows' scales differ). The saved statistics are
# means over an item's (K, ch), each column held on its own. The chain (kernel
# forward, then kernel backward on its residuals) against the plain chain
# also sees the residuals' flips, carried through the blocks: bf16 noise of
# the size that puts either chain ~0.1 (rel L2) from an fp32 oracle, so 0.2.
TRAIN_TRUNK_GRAD_REL = 3e-2
TRAIN_TRUNK_STATS_REL = 1e-4
TRAIN_TRUNK_CHAIN_REL = 0.2
DVEC_ROWS = (0, 1, 2, 3, 4, 5, 6, 8, 9)  # row 7 of stack_canonical's vecs is unused
TRAIN_TRUNK_FP32_REL = 1e-4  # fp32 plain backward against autograd through trunk_reference


def _canonical_inputs(batch, frames, cb, ch, dils, device, seed):
    n = len(dils)
    vdim = max(ch, 2 * cb)
    vecs = _normal((n, 10, vdim), seed) * 0.1
    vecs[:, 1] += 1.0  # norm1 gamma near 1
    vecs[:, 4] += 1.0  # norm2 gamma near 1
    vecs[:, 7] = 0.0
    vecs[:, 8], vecs[:, 9] = 0.25, 0.2  # PReLU slopes
    return (
        _normal((batch, frames, cb), seed + 1).to(device),
        (_normal((n, cb, ch), seed + 2) / np.sqrt(cb)).to(device),
        (_normal((n, 3, ch), seed + 3) / np.sqrt(3)).to(device),
        (_normal((n, ch, 2 * cb), seed + 4) / np.sqrt(ch)).to(device),
        vecs.to(device),
    )


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("frames", [130, 1100, 4003])  # ragged: no multiple of a tile
@pytest.mark.parametrize("cb,ch", [(32, 48), (128, 256)])
def test_tcn_train_kernels_match_plain(cuda_device, frames, cb, ch):
    dils = (1, 2, 4, 8, 16, 32, 64, 1)
    h0, we, wdw, wcat, vecs = _canonical_inputs(2, frames, cb, ch, dils, cuda_device, seed=50)
    folded = fold_canonical(we, wdw, wcat, vecs)
    before = (tcn_train_forward.launches, tcn_train_backward.launches)
    skip, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    want = tcn_train_forward_plain(h0, *folded, dils=dils)
    torch.cuda.synchronize()
    assert torch.equal(skip, tcn_trunk_cuda(h0, *folded, dils=dils))  # the serving trunk
    assert skip.dtype == hb.dtype == torch.bfloat16 and hb.shape == (len(dils), 2, frames, cb)
    assert st.shape == (len(dils), 2, 4)
    for got, ref in zip((skip, hb), want[:2]):
        bound = TRUNK_BF16_REL * max(1.0, ref.float().abs().max().item())
        assert (got.float() - ref.float()).abs().max().item() <= bound
    for col in range(4):  # mu1, 1/sigma1, mu2, 1/sigma2
        assert _rel(st[..., col], want[2][..., col]) <= TRAIN_TRUNK_STATS_REL, col
    dskip = _normal((2, frames, cb), seed=60).to(cuda_device)
    _hold_backward(dskip, hb, st, want, (we, wdw, wcat, vecs), dils)
    assert (tcn_train_forward.launches - before[0], tcn_train_backward.launches - before[1]) == (1, 2)


def _hold_backward(dskip, hb, st, want, canon, dils):
    """The backward kernel on the kernel forward's residuals (hb, st) against
    the plain backward on the same and against the plain chain (the plain
    backward on the plain forward's residuals ``want``), per gradient and used
    dvec row; rerun bit-identical."""
    got = tcn_train_backward(dskip, hb, st, *canon, dils=dils)
    again = tcn_train_backward(dskip, hb, st, *canon, dils=dils)
    ref = tcn_train_backward_plain(dskip, hb, st, *canon, dils=dils)
    chain = tcn_train_backward_plain(dskip, want[1], want[2], *canon, dils=dils)
    torch.cuda.synchronize()
    for name, g, a, r, c in zip(("dh0", "dwe", "dwdw", "dwcat", "dvec"), got, again, ref, chain):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        assert torch.equal(g, a), name  # fixed-order sums: bit-identical reruns
        parts = ([(f"dvec[{row}]", g[:, row], r[:, row], c[:, row]) for row in DVEC_ROWS]
                 if name == "dvec" else [(name, g, r, c)])
        for what, gp, rp, cp in parts:
            assert _rel(gp, rp) <= TRAIN_TRUNK_GRAD_REL, (what, _rel(gp, rp))
            assert _rel(gp, cp) <= TRAIN_TRUNK_CHAIN_REL, (what, _rel(gp, cp))
    assert not got[4][:, 7].any()


# the backward plan's edges at full width (21 blocks, dilations 1 to 64):
# several tiles a CTA, more items than SMs (a group walks two), items below
# the dilation-64 halo, one item
@pytest.mark.parametrize("batch,frames", [(7, 3000), (140, 50), (3, 50), (1, 700)])
def test_tcn_train_backward_at_the_plan_edges(cuda_device, batch, frames):
    dils = tuple(2**x for _ in range(3) for x in range(7))
    h0, *canon = _canonical_inputs(batch, frames, 128, 256, dils, cuda_device, seed=55)
    folded = fold_canonical(*canon)
    _, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    want = tcn_train_forward_plain(h0, *folded, dils=dils)
    dskip = _normal((batch, frames, 128), seed=65).to(cuda_device)
    before = tcn_train_backward.launches
    _hold_backward(dskip, hb, st, want, canon, dils)
    assert tcn_train_backward.launches - before == 2  # one launch a call


def test_tcn_train_backward_laps(cuda_device):
    """The timed instance of the backward: one lap a part of a block for every
    CTA of the plan, and the same gradients as the untimed one."""
    dils = (1, 2, 4, 8)
    h0, *canon = _canonical_inputs(2, 600, 32, 48, dils, cuda_device, seed=75)
    _, hb, st = tcn_train_forward(h0, *fold_canonical(*canon), dils=dils)
    dskip = _normal((2, 600, 32), seed=76).to(cuda_device)
    laps = trunk_backward_phase_ms(dskip, hb, st, *canon, dils=dils)
    plan = tcn_backward_plan(2, 600, 32, 48, 3, dils, **_device_limits(torch.device(cuda_device)))
    assert (laps["groups"], laps["ctas"]) == (plan.groups, plan.ctas)
    assert all(laps[p] >= 0.0 for p in TRUNK_BWD_LAPS) and laps["P5 taps"] > 0.0
    got = tcn_train_backward(dskip, hb, st, *canon, dils=dils)
    grads = launch_backward(dskip, hb, st, *canon, dils=dils, taps=3, name="timed",
                            timing=torch.zeros((plan.grid, len(TRUNK_BWD_LAPS)), dtype=torch.int64,
                                               device=cuda_device))
    assert all(torch.equal(a, b) for a, b in zip(got, grads))


def test_tcn_trunk_train_grads_match_autograd(cuda_device):
    """The kernel path's gradients (bf16) and the plain path's in fp32 storage
    against autograd through the fp32 trunk_reference."""
    dils = (1, 2, 4, 8, 1, 2)
    inputs = _canonical_inputs(2, 300, 32, 48, dils, cuda_device, seed=70)
    probe = _normal((2, 300, 32), seed=80).to(cuda_device)
    grads = {}
    for kind in ("kernel", "fp32", "reference"):
        params = [t.clone().requires_grad_() for t in inputs]
        if kind == "reference":
            out = trunk_reference(*params, dils=dils)
        else:
            out = tcn_trunk_train(*params, dils=dils, plain=kind == "fp32",
                                  storage=torch.float32 if kind == "fp32" else torch.bfloat16)
        (out.float() * probe).sum().backward()
        grads[kind] = [p.grad for p in params]
    for i, want in enumerate(grads["reference"]):
        if i == 4:  # the PReLU slopes' lanes are summed by stack_canonical
            want = torch.cat([want[:, :8].flatten(), want[:, 8:].sum(-1).flatten()])
            got = {k: torch.cat([g[4][:, :8].flatten(), g[4][:, 8:].sum(-1).flatten()])
                   for k, g in grads.items()}
        else:
            got = {k: g[i] for k, g in grads.items()}
        assert _rel(got["fp32"], want) <= TRAIN_TRUNK_FP32_REL, i
        assert _rel(got["kernel"], want) <= 0.2, i  # bf16 storage: ~15-20 dB, as on the TPU


def test_tcn_train_kernels_raise(cuda_device):
    dils = (1, 2, 4, 8)
    h0, we, wdw, wcat, vecs = _canonical_inputs(1, 100, 32, 48, dils, cuda_device, seed=90)
    folded = fold_canonical(we, wdw, wcat, vecs)
    with pytest.raises(ValueError, match="tensors on"):
        tcn_train_forward(h0, folded[0].cpu(), *folded[1:], dils=dils)
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        tcn_train_forward(h0, *fold_canonical(we, wdw, wcat, vecs, torch.float32), dils=dils)
    with pytest.raises(ValueError, match="needs plain=True"):
        tcn_trunk_train(h0, we, wdw, wcat, vecs, dils=dils, storage=torch.float32)
    _, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    with pytest.raises(ValueError, match="dskip"):
        tcn_train_backward(h0[:, :-1], hb, st, we, wdw, wcat, vecs, dils=dils)
    with pytest.raises(ValueError, match="tensors on"):
        tcn_train_backward(h0, hb, st.cpu(), we, wdw, wcat, vecs, dils=dils)
    # no fallback: a shape outside the kernel's plan raises
    with pytest.raises(ValueError, match="dilations"):
        tcn_train_backward(h0, hb, st, we, wdw, wcat, vecs, dils=(1, 2, 4, 65))


def _near_tie_rows(flat, codebook, got, want):
    """Rows where ``got`` and ``want`` differ, each asserted to be a near tie."""
    rows = (got != want).nonzero().flatten().cpu()
    x, e = flat.double().cpu(), codebook.double().cpu()
    for i in rows.tolist():
        da = ((x[i] - e[:, int(got[i])]) ** 2).sum().item()
        db = ((x[i] - e[:, int(want[i])]) ** 2).sum().item()
        scale = (x[i] ** 2).sum().item() + (e**2).sum(0).max().item()
        assert abs(da - db) <= NEAR_TIE_REL * scale, (i, da, db)
    return rows


@pytest.mark.parametrize("n,d,k", [(12800, 64, 512), (51200, 16, 512), (12803, 13, 509),
                                   (5, 64, 3), (700, 256, 130)])
def test_nearest_code_kernel_matches_plain(cuda_device, n, d, k):
    flat = _normal((n, d), seed=100).to(cuda_device)
    codebook = _normal((d, k), seed=101).to(cuda_device)
    before = nearest_code.launches
    got = nearest_code(flat, codebook)
    torch.cuda.synchronize()
    assert nearest_code.launches == before + 1
    want = nearest_code_plain(flat, codebook)
    assert got.dtype == want.dtype == torch.int32 and got.shape == (n,)
    assert len(_near_tie_rows(flat, codebook, got, want)) <= max(1, n // 1000)
    # exact inputs: every score is exact in fp32, so every index is equal
    exact_x = (torch.round(flat * 8).clamp(-32, 32) / 32).contiguous()
    exact_cb = (torch.round(codebook * 8).clamp(-32, 32) / 32).contiguous()
    assert torch.equal(nearest_code(exact_x, exact_cb), nearest_code_plain(exact_x, exact_cb))


def test_nearest_code_kernel_ties_pick_the_lowest_index(cuda_device):
    codebook = _normal((16, 40), seed=102).to(cuda_device)
    codebook = torch.cat([codebook, codebook, codebook[:, :5]], dim=1).contiguous()  # 85 codes
    flat = codebook[:, [3, 7, 45, 60, 82]].T.contiguous()
    got = nearest_code(flat, codebook)
    assert got.tolist() == [3, 7, 5, 20, 2]
    assert torch.equal(got, nearest_code_plain(flat, codebook))


def test_nearest_code_kernel_raises(cuda_device):
    flat = _normal((10, 16), seed=103).to(cuda_device)
    codebook = _normal((16, 20), seed=104).to(cuda_device)
    with pytest.raises(ValueError, match="unsupported devices"):
        nearest_code(flat, codebook.cpu())
    with pytest.raises(TypeError, match="float32"):
        nearest_code(flat.double(), codebook.double())
    with pytest.raises(ValueError, match="contiguous"):
        nearest_code(flat, codebook.T.contiguous().T)
    with pytest.raises(ValueError, match="expected flat"):
        nearest_code(flat, codebook[:8].contiguous())
    with pytest.raises(ValueError, match="D <= 256"):
        nearest_code(_normal((4, 300), 0).to(cuda_device), _normal((300, 8), 1).to(cuda_device))
    assert nearest_code(flat[:0], codebook).shape == (0,)


# (N, G, S, K): a t3tok skip stage (4 groups of 16), ragged N and K with 4-byte
# copies, groups crossing CTAs' ranges at a small N, and codebooks past the
# shared memory (streamed: S = 256 at K = 1,024, and K = 4,096)
GROUPED_SHAPES = [(51200, 4, 16, 512), (12803, 3, 13, 509), (37, 8, 8, 64), (700, 1, 256, 1024),
                  (300, 2, 16, 4096)]


def _grouped_near_ties(flat, codebook, got, want):
    """Each group's picks against the plain version's, differing only at near ties."""
    s = codebook.shape[1]
    return sum(len(_near_tie_rows(flat[:, g * s:(g + 1) * s], codebook[g], got[:, g], want[:, g]))
               for g in range(codebook.shape[0]))


@pytest.mark.parametrize("n,g,s,k", GROUPED_SHAPES)
def test_nearest_code_grouped_kernel_matches_plain(cuda_device, n, g, s, k):
    flat = _normal((n, g * s), seed=110).to(cuda_device)
    codebook = _normal((g, s, k), seed=111).to(cuda_device)
    before = nearest_code.launches
    got = nearest_code(flat, codebook)
    again = nearest_code(flat, codebook)
    torch.cuda.synchronize()
    assert nearest_code.launches == before + 2  # one launch a call, every group in it
    want = nearest_code_plain(flat, codebook)
    assert got.dtype == want.dtype == torch.int32 and got.shape == (n, g)
    assert torch.equal(got, again)  # reruns bit-identical
    assert _grouped_near_ties(flat, codebook, got, want) <= max(1, n * g // 1000)
    # each group alone through the 2-D call picks the same, bit for bit
    for j in range(g):
        alone = nearest_code(flat[:, j * s:(j + 1) * s].contiguous(), codebook[j].contiguous())
        assert torch.equal(alone, got[:, j])


def test_nearest_code_reads_strided_rows_in_place(cuda_device):
    wide = _normal((5000, 80), seed=112).to(cuda_device)
    codebook = _normal((4, 16, 512), seed=113).to(cuda_device)
    flat = wide[:, 8:72]  # row stride 80, columns contiguous: no copy
    got = nearest_code(flat, codebook)
    assert torch.equal(got, nearest_code(flat.contiguous(), codebook))
    assert _grouped_near_ties(flat, codebook, got, nearest_code_plain(flat, codebook)) <= 5
    odd = wide[:, 3:67]  # a row start off 16 bytes: the 4-byte copies
    assert torch.equal(nearest_code(odd, codebook), nearest_code(odd.contiguous(), codebook))
    with pytest.raises(ValueError, match="contiguous"):
        nearest_code(wide.T.contiguous().T[:, :64], codebook)  # columns not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        nearest_code(flat, codebook.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.parametrize("s,k", [(16, 512), (256, 1024)])
def test_nearest_code_grouped_exact_ties_pick_the_lowest_index(cuda_device, s, k):
    # multiples of 1/32: every score exact in any order, so duplicated codes tie exactly
    base = (torch.round(_normal((2, s, k // 2), seed=114) * 8).clamp(-32, 32) / 32).to(cuda_device)
    codebook = torch.cat([base, base], dim=2).contiguous()  # code c and c + k/2 equal
    picks = torch.from_numpy(np.random.default_rng(115).integers(0, k, (2, 600))).to(cuda_device)
    flat = torch.cat([codebook[j][:, picks[j]].T for j in range(2)], dim=1).contiguous()
    got = nearest_code(flat, codebook)
    assert torch.equal(got, (picks % (k // 2)).T.to(torch.int32))
    assert torch.equal(got, nearest_code_plain(flat, codebook))


def test_nearest_code_all_nan_rows_get_index_zero(cuda_device):
    flat = _normal((40, 32), seed=116).to(cuda_device)
    flat[[3, 17, 39], 5:9] = float("nan")  # group 0 of three rows
    got = nearest_code(flat, _normal((2, 16, 300), seed=117).to(cuda_device))
    assert got[[3, 17, 39], 0].tolist() == [0, 0, 0]


def _exact(t):
    """Multiples of 1/32 in [-1, 1]: every score exact in fp32 in any order."""
    return (torch.round(t * 8).clamp(-32, 32) / 32).contiguous()


# resident and streamed codebooks (D = 256, K = 1,024), 2-D and grouped
@pytest.mark.parametrize("form,s,k", [("2d", 64, 512), ("2d", 256, 1024), ("grouped", 16, 300),
                                      ("grouped", 256, 1024)])
@pytest.mark.parametrize("case", ["nan_column", "inf_row"])
def test_nearest_code_picks_the_first_nan_as_argmin_does(cuda_device, form, s, k, case):
    g = 1 if form == "2d" else 2
    flat, codebook = _exact(_normal((700, g * s), seed=118)), _exact(_normal((g, s, k), seed=119))
    rows = [0, 17, 350, 699]
    if case == "nan_column":  # columns 2 and 7 of the last group score NaN on every row
        codebook[g - 1, 3, 2] = codebook[g - 1, 0, 7] = float("nan")
        want_rows, want_pick = list(range(700)), 2
    else:  # inf x 0 = NaN: codes 9 and 40 of the last group on the rows holding an inf
        flat[rows, (g - 1) * s + 5] = torch.tensor([float("inf"), -float("inf")] * 2)
        column = codebook[g - 1, 5]
        column[column == 0] = 1 / 32  # no other code holds a 0 there
        column[[9, 40]] = 0.0
        want_rows, want_pick = rows, 9
    book = codebook[0].contiguous() if form == "2d" else codebook
    want = nearest_code_plain(flat, book)  # torch.argmin on the CPU
    last = want if form == "2d" else want[:, g - 1]
    assert last[want_rows].tolist() == [want_pick] * len(want_rows)
    flat, book = flat.to(cuda_device), book.to(cuda_device)
    got, again = nearest_code(flat, book), nearest_code(flat, book)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert torch.equal(got, nearest_code_plain(flat, book))  # and on the card


def test_vector_quantizers_on_the_card_launch_the_kernel(cuda_device):
    gen = torch.Generator().manual_seed(0)
    vq = VectorQuantizer(64, 16, init_scale=1.0, generator=gen).to(cuda_device)
    rvq = ResidualVectorQuantizer(32, 16, depth=2, pq=4, generator=gen).to(cuda_device)
    x = _normal((3, 50, 16), seed=105).to(cuda_device)
    for layer, launches in ((vq, 1), (rvq, 2)):  # the RVQ: one grouped launch a stage
        before = nearest_code.launches
        with torch.no_grad():
            out, aux = layer(x)
            want, want_aux = layer(x, plain=True)
        torch.cuda.synchronize()
        assert nearest_code.launches == before + launches
        assert (out - want).abs().max().item() <= 1e-6
        assert abs(aux.item() - want_aux.item()) <= 1e-6 * max(1.0, abs(want_aux.item()))
    model = VqVaeT3Tok(embedding_dim=16, num_embeddings=32, skip_embeddings=32, skip_pq=4,
                       generator=gen).to(cuda_device).eval()
    frames = (0.3 * _normal((2, 64, 40), seed=106)).to(cuda_device)
    before = nearest_code.launches
    with torch.no_grad():
        deep, skip = model.codes(frames)
        plain = model.codes(frames, plain=True)
    assert nearest_code.launches == before + 2 + 2  # 2 deep stages, 2 skip stages of pq 4 each
    assert torch.equal(deep, plain[0]) and torch.equal(skip, plain[1])
