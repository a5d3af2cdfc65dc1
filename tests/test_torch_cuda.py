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
from torch.utils._python_dispatch import TorchDispatchMode

from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.blstm import BiLSTM
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.ops import plain_versions
from speech_separation_tpu_torch.ops.lstm_cuda import (
    _device_limits as _lstm_limits,
    _forward_launch,
    forward_plan,
    lstm_recurrence,
    lstm_recurrence_plain,
    row_slices,
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
from speech_separation_tpu_torch.models.dprnn import DPRNN
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
from speech_separation_tpu_torch.separate import pipeline
from speech_separation_tpu_torch.separate.pipeline import make_separate_fn
from speech_separation_tpu_torch.separate.streaming import StreamingSeparator
from speech_separation_tpu_torch.separate.streaming_stateful import stateful_stream_separate

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
    (2, 300, 12, 496),  # one launch of 10 groups a block
    (2, 600, 12, 496),  # two row slices, two launches a call
    (1, 16, 40, 496), (2, 3, 37, 20), (2, 5, 19, 21),  # D = 1; ragged B and H (unaligned rows)
    (2, 40, 8, 1024),  # fp32 reads U through L1 from L2
    (2, 256, 16, 256),  # fp32: 4 groups a block, two a pass
])
def test_lstm_forward_kernels_match_plain(cuda_device, dtype, atol, dirs, batch, steps, hidden):
    """The persistent forward, serving and training modes: within the plain
    version's bound, one launch a call per row slice, reruns bit-identical."""
    xw, u, k = _train_inputs(dirs, batch, steps, hidden, cuda_device, seed=31, keep=dirs == 2)
    slices = len(forward_plan(batch, hidden, dtype == torch.bfloat16, dirs,
                              **_lstm_limits(cuda_device)).slices)
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
        with plain_versions():
            want = model(mag)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4


def _serving_batch(device, tmp_path):
    root = make_synthetic_fixture(tmp_path, utterances_per_split=2, min_seconds=0.5, max_seconds=1.5)
    batch = next(iter(WaveformLoader(pathlib.Path(root) / "tt", batch_size=2)))
    model = UPitBlstm(hidden=40, num_layers=2, generator=torch.Generator().manual_seed(0))
    mix = torch.from_numpy(batch.mix).to(device)
    return model.to(device), mix, torch.from_numpy(batch.frame_lengths).to(device)


def test_separate_kernel_path_matches_plain(cuda_device, tmp_path):
    model, mix, lens = _serving_batch(cuda_device, tmp_path)
    got = make_separate_fn(model)(mix, lens)
    with plain_versions():
        want = make_separate_fn(model)(mix, lens)
    torch.cuda.synchronize()
    assert got.device.type == want.device.type == "cpu"
    assert torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= PATH_REL


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "quantize_output"])
def test_separate_returns_pinned_host_estimates(cuda_device, tmp_path, monkeypatch, quantize):
    model, mix, lens = _serving_batch(cuda_device, tmp_path)
    got = make_separate_fn(model, quantize_output=quantize)(mix, lens)
    monkeypatch.setattr(pipeline, "to_host", lambda x: x)  # the device result, as before
    on_device = make_separate_fn(model, quantize_output=quantize)(mix, lens)
    got, on_device = (got, on_device) if quantize else ((got,), (on_device,))
    assert len(got) == len(on_device) == (2 if quantize else 1)
    for g, d in zip(got, on_device):
        assert g.device.type == "cpu" and g.is_pinned() and d.device.type == "cuda"
        assert g.dtype == d.dtype and torch.equal(g, d.cpu())  # bit for bit
    if quantize:
        assert got[0].dtype == torch.int16


def test_separate_results_outlive_later_calls(cuda_device, tmp_path):
    model, mix, lens = _serving_batch(cuda_device, tmp_path)
    separate = make_separate_fn(model)
    held = separate(mix, lens).numpy()  # only the numpy view holds the pinned block
    saved = held.copy()
    other = separate(0.5 * mix.flip(0), lens.flip(0)).numpy()
    for _ in range(4):  # the same size class again: a freed block would be handed out here
        separate(mix.flip(0), lens.flip(0))
    assert not np.array_equal(other, saved)
    np.testing.assert_array_equal(held, saved)


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


@pytest.mark.parametrize("which", ["bilstm", "upit"])
def test_modules_under_autograd_match_plain(cuda_device, which):
    """``BiLSTM`` and ``UPitBlstm`` called under autograd on CUDA tensors run
    the training kernels and return a result with gradients: their outputs
    and every parameter's gradient against the plain path's (a module that
    served here would leave its parameters' gradients empty)."""
    gen = torch.Generator().manual_seed(0)
    if which == "bilstm":
        model, layers = BiLSTM(12, 20, generator=gen), 1
        x, probe = _normal((5, 23, 12), seed=8) * 0.5, _normal((5, 23, 40), seed=13)
    else:
        model, layers = UPitBlstm(hidden=40, num_layers=2, dropout_rate=0.0, generator=gen), 2
        x, probe = _normal((3, 30, 129), seed=3).abs(), _normal((3, 30, 258), seed=13)
    model, x, probe = model.to(cuda_device), x.to(cuda_device), probe.to(cuda_device)
    outs, grads = {}, {}
    for kind in ("kernel", "plain"):
        model.zero_grad(set_to_none=True)
        before = (lstm_train_forward.launches, lstm_train_backward.launches)
        with plain_versions(kind == "plain"):
            y = model(x)
        assert y.grad_fn is not None
        (y * probe).sum().backward()  # outside the switch: the backward keeps the forward's choice
        launched = (lstm_train_forward.launches - before[0], lstm_train_backward.launches - before[1])
        assert launched == ((layers, layers) if kind == "kernel" else (0, 0))
        outs[kind] = y.detach()
        grads[kind] = [p.grad for p in model.parameters()]
    assert (outs["kernel"] - outs["plain"]).abs().max().item() <= TRAIN_ATOL
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert got is not None and ((got - want).norm() / want.norm()).item() <= GRAD_REL


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
        before = (lstm_train_forward.launches, lstm_train_backward.launches,
                  lstm_recurrence.launches)
        train_step, eval_step = train.make_upit_waveform_steps(model)
        with plain_versions(kind == "plain"):
            losses[kind] = [train_step(state, *arrays)[1].item() for _ in range(3)]
            losses[kind].append(eval_step(state, *arrays).item())
        launched = (lstm_train_forward.launches - before[0], lstm_train_backward.launches - before[1],
                    lstm_recurrence.launches - before[2])
        # three steps in the training kernels, the eval step (no gradient) in the serving one
        assert launched == ((2 * 3, 2 * 3, 2) if kind == "kernel" else (0, 0, 0))
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
        model = UPitBlstm(hidden=64, num_layers=2, dropout_rate=0.0,
                          generator=torch.Generator().manual_seed(0)).to(cuda_device)
        before = (lstm_train_forward.keep_launches, lstm_train_backward.keep_launches)
        with plain_versions(kind == "plain"):
            feats = psm_features(mix, sources)
            preds = model(feats.magnitude, segment_ids=seg)
            loss = pit_loss_packed(preds, feats.labels, seg, num_segments=loader.num_segments)
            loss.backward()
        launched = (lstm_train_forward.keep_launches - before[0],
                    lstm_train_backward.keep_launches - before[1])
        assert launched == ((2, 2) if kind == "kernel" else (0, 0))  # one a layer
        grads[kind] = [p.grad.detach().clone() for p in model.parameters()]
        state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
        train_step, eval_step = train.make_upit_packed_steps(model, num_segments=loader.num_segments)
        with plain_versions(kind == "plain"):
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


def _device_inputs(dirs, batch, steps, hidden, device, seed):
    """DPRNN-sized recurrence inputs drawn on the card (gigabytes of them)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xw = torch.randn((dirs, batch, steps, 4 * hidden), generator=gen, device=device)
    u = torch.randn((dirs, hidden, 4 * hidden), generator=gen, device=device) / np.sqrt(hidden)
    return xw, u


@pytest.mark.parametrize("dtype,atol", [(torch.float32, LSTM_ATOL), (torch.bfloat16, LSTM_BF16_ATOL)])
@pytest.mark.parametrize("batch,steps", [(4_000, 641), (10_256, 250)])  # DPRNN's inter and intra rows
def test_lstm_kernel_at_the_dual_path_shapes(cuda_device, dtype, atol, batch, steps):
    """Row 2 at H = 128 over a 16 x 10 s batch's BiLSTM rows (K = 250, S =
    641): one launch a row slice of the plan (2 and 6, of up to 2,048 rows),
    within the plain loop's bound."""
    xw, u = _device_inputs(2, batch, steps, 128, cuda_device, seed=41)
    plan = forward_plan(batch, 128, dtype == torch.bfloat16, 2, **_lstm_limits(cuda_device))
    before = lstm_recurrence.launches
    got = lstm_recurrence(xw, u, reverse=(False, True), compute_dtype=dtype)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches == before + len(plan.slices)
    want = lstm_recurrence_plain(xw, u, reverse=(False, True), compute_dtype=dtype)
    assert (got.float() - want.float()).abs().max().item() <= _bound(atol, dtype, [want])


@pytest.mark.parametrize("dtype,atol", [(torch.float32, TRAIN_ATOL), (torch.bfloat16, TRAIN_BF16_ATOL)])
def test_lstm_train_kernels_at_the_dual_path_width(cuda_device, dtype, atol):
    """Rows 3 and 4 at H = 128 over 1,028 rows of 250 steps (a DPRNN training
    batch's intra rows): the forward in its plan's launches (one), the
    backward in five row slices of 256, within the plain loops' bound."""
    batch, steps, hidden = 1_028, 250, 128
    xw, u = _device_inputs(2, batch, steps, hidden, cuda_device, seed=43)
    before = (lstm_train_forward.launches, lstm_train_backward.launches)
    got = lstm_train_forward(xw, u, compute_dtype=dtype)
    want = lstm_train_forward_plain(xw, u, compute_dtype=dtype)
    torch.cuda.synchronize()
    bound = _bound(atol, dtype, want)
    for g, w, name in zip(got, want, ("out", "gates", "c_all")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert (g.float() - w.float()).abs().max().item() <= bound, name
    _, gates, c_all = want
    dy = torch.randn((batch, steps, 2 * hidden), generator=torch.Generator(
        device=cuda_device).manual_seed(44), device=cuda_device).to(dtype)
    got_dg = lstm_train_backward(gates, c_all, dy, u, compute_dtype=dtype)
    again = lstm_train_backward(gates, c_all, dy, u, compute_dtype=dtype)
    want_dg = lstm_train_backward_plain(gates, c_all, dy, u, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert torch.equal(got_dg, again)
    assert (got_dg.float() - want_dg.float()).abs().max().item() <= _bound(atol, dtype, [want_dg])
    plan = forward_plan(batch, hidden, dtype == torch.bfloat16, 2, **_lstm_limits(cuda_device))
    launched = (lstm_train_forward.launches - before[0], lstm_train_backward.launches - before[1])
    assert launched == (len(plan.slices), 2 * len(row_slices(batch)))


@pytest.mark.parametrize("mode", ["serving", "training", "training with keep"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_forward_plan_equals_256_row_slices(cuda_device, dtype, mode):
    """The plan's few full-grid launches (4,100 rows at H = 128: 1,376 +
    1,376 + 1,348, 11 groups a block, the next pass's copies ahead) against
    the same kernel in 256-row slices, one launch each, with as many groups
    a pass: the same sums in the same order, so every output bit for bit."""
    batch, steps, hidden = 4_100, 24, 128
    bf16 = dtype == torch.bfloat16
    limits = _lstm_limits(cuda_device)
    plan = forward_plan(batch, hidden, bf16, 2, **limits)
    assert len(plan.slices) == 3 and plan.slices[-1][1] % 16 and plan.ahead
    small = forward_plan(256, hidden, bf16, 2, **limits)
    groups = max(small.groups, plan.pass_groups)
    sliced = dataclasses.replace(plan, groups=groups, row_blocks=-(-16 // groups), ahead=False,
                                 slices=row_slices(batch))
    xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=51,
                             keep=mode == "training with keep")
    xw, u = xw.to(dtype), u.to(dtype)
    results = []
    for p in (plan, sliced):
        out = torch.empty(batch, steps, 2 * hidden, dtype=dtype, device=cuda_device)
        if mode == "serving":
            _forward_launch(lstm_recurrence, xw, u, out, 0b10, p)
            results.append((out,))
        else:
            gates = torch.empty(2, batch, steps, 4 * hidden, dtype=dtype, device=cuda_device)
            c_all = torch.empty(2, batch, steps, hidden, device=cuda_device)
            _forward_launch(lstm_train_forward, xw, u, out, 0b10, p, gates=gates, c_all=c_all,
                            keep=k)
            results.append((out, gates, c_all))
    torch.cuda.synchronize()
    for got, want in zip(*results):
        assert torch.equal(got, want)
    if mode == "serving":  # and the first rows within the plain loop's bound
        want = lstm_recurrence_plain(xw[:, :300], u, reverse=(False, True), compute_dtype=dtype)
        atol = LSTM_ATOL if dtype == torch.float32 else LSTM_BF16_ATOL
        got = results[0][0][:300].float()
        assert (got - want.float()).abs().max().item() <= _bound(atol, dtype, [want])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_forward_misaligned_input_is_copied(cuda_device, dtype):
    """xw two elements off 16-byte alignment (a view into a flat buffer)
    under a plan that copies xw_t ahead 16 bytes at a time: the wrapper
    copies it, and the outputs equal those of the aligned tensor bit for
    bit."""
    batch, steps, hidden = 600, 6, 128
    xw, u, _ = _train_inputs(2, batch, steps, hidden, cuda_device, seed=53, keep=False)
    xw, u = xw.to(dtype), u.to(dtype)
    bf16 = dtype == torch.bfloat16
    assert forward_plan(batch, hidden, bf16, 2, **_lstm_limits(cuda_device)).ahead
    flat = torch.empty(xw.numel() + 2, dtype=dtype, device=cuda_device)
    odd = flat[2:].view(xw.shape)
    odd.copy_(xw)
    assert odd.data_ptr() % 16
    got = lstm_recurrence(odd, u, reverse=(False, True))
    assert torch.equal(got, lstm_recurrence(xw, u, reverse=(False, True)))
    assert torch.equal(lstm_train_forward(odd, u)[2], lstm_train_forward(xw, u)[2])


@pytest.mark.parametrize("keep", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_train_backward_row_slices(cuda_device, dtype, keep):
    """The backward in row slices of 256: a batch of one slice is the one
    launch over the whole batch it was before the slicing, bit for bit, and a
    batch of three slices equals each slice's rows run on their own."""
    hidden, steps = 128, 40
    bf16 = dtype == torch.bfloat16
    for batch in (200, 256):
        xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=47, keep=keep)
        _, gates, c_all = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dtype)
        dy = _normal((batch, steps, 2 * hidden), seed=48).to(cuda_device).to(dtype)
        got = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
        whole = torch.empty_like(got)
        _backward_launch(gates.to(dtype).contiguous(), c_all.float().contiguous(), dy.contiguous(),
                         u.to(dtype).contiguous(), k, whole,
                         backward_plan(batch, hidden, bf16, **_lstm_limits(gates.device)))
        torch.cuda.synchronize()
        assert torch.equal(got, whole), batch
    batch = 600
    slices = row_slices(batch)
    assert len(slices) == 3
    xw, u, k = _train_inputs(2, batch, steps, hidden, cuda_device, seed=49, keep=keep)
    _, gates, c_all = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dtype)
    dy = _normal((batch, steps, 2 * hidden), seed=50).to(cuda_device).to(dtype)
    before = lstm_train_backward.launches
    got = lstm_train_backward(gates, c_all, dy, u, keep=k, compute_dtype=dtype)
    assert lstm_train_backward.launches == before + 3
    parts = [lstm_train_backward(gates[:, r0:r0 + n], c_all[:, r0:r0 + n], dy[r0:r0 + n], u,
                                 keep=None if k is None else k[:, r0:r0 + n], compute_dtype=dtype)
             for r0, n in slices]
    torch.cuda.synchronize()
    assert torch.equal(got, torch.cat(parts, dim=1))


def test_dprnn_module_matches_the_reference(cuda_device):
    """DPRNN at toy widths on the card: serving (row 2) and the SI-SDR PIT
    loss's gradients (rows 3, 4) against the benchmark's plain reference."""
    from bench_torch.reference import dprnn as reference
    from speech_separation_tpu_torch.losses import pit_si_sdr_loss

    toy = dict(num_speakers=2, enc_dim=8, win=2, bottleneck=8, hidden=16, chunk=10, blocks=2)
    weights = reference.make_weights(toy, 7, cuda_device)
    model = DPRNN(**toy).to(cuda_device)
    model.load_state_dict(weights)
    mix = _normal((3, 523), seed=45).to(cuda_device)
    before = (lstm_recurrence.launches, lstm_train_forward.launches, lstm_train_backward.launches)
    with torch.no_grad():
        got = model(mix)
    want = reference.separate(weights, toy, mix)
    assert (got - want).abs().max().item() <= 1e-4
    sources, lengths = _normal((3, 2, 523), seed=46).to(cuda_device), torch.tensor([523, 400, 300])
    pit_si_sdr_loss(model(mix), sources, lengths).backward()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss = pit_si_sdr_loss(reference.forward(params, toy, mix), sources, lengths)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for name, p in model.named_parameters():
        assert ((p.grad - grads[name]).norm() / grads[name].norm()).item() <= GRAD_REL, name
    # four BiLSTMs, served in row 2 and trained in rows 3 and 4: an intra one over
    # 3 x 106 chunks, an inter one over 3 x 10 positions; the forward in its plan's
    # launches (one each), the backward in row slices of 256 (two, one)
    forward = 2 * sum(len(forward_plan(rows, 16, False, 2, **_lstm_limits(cuda_device)).slices)
                      for rows in (3 * 106, 3 * 10))
    backward = 2 * sum(len(row_slices(rows)) for rows in (3 * 106, 3 * 10))
    assert (forward, backward) == (4, 6)
    assert (lstm_recurrence.launches - before[0], lstm_train_forward.launches - before[1],
            lstm_train_backward.launches - before[2]) == (forward, forward, backward)
    with pytest.raises(ValueError, match="H=1100"):  # the plan's own refusal, no fallback
        with torch.no_grad():
            DPRNN(**{**toy, "hidden": 1100}).to(cuda_device)(mix)


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


@pytest.mark.parametrize("frames", [2000, 4000])  # 16 and 32 tiles: one group of 16 or 32 CTAs
def test_tcn_trunk_kernel_at_the_window_engines_batch_1(cuda_device, frames):
    """The window streaming engine's one window a hop (B = 1; K = 2,000, not a
    multiple of the 128-row tile, and 4,000) at full width, the dilation-64
    halo included."""
    dils = tuple(2**x for _ in range(3) for x in range(7))
    plan = trunk_plan(1, frames, 128, 256, 3, dils, **_device_limits(cuda_device))
    assert (plan.groups, plan.ctas) == (1, -(-frames // 128))
    _check_trunk_kernel(_trunk_inputs(1, frames, 128, 256, dils, cuda_device, seed=23), dils)


def test_window_stream_launches_the_trunk_once_a_hop(cuda_device):
    """The window engine over ``cuda_apply``: one trunk kernel a hop on the
    device (the first hop eager, the second captured, the rest replayed), and
    each hop within the kernel path's bound of the plain trunk's."""
    model = ConvTasNet(enc_dim=64, bottleneck=32, hidden=48, blocks=4, repeats=2,
                       generator=torch.Generator().manual_seed(0)).to(cuda_device)
    mix = (_normal((6000,), seed=41) * 0.3).numpy()
    streams = {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for plain in (False, True):
        sep = StreamingSeparator(lambda m: cuda_apply(model, m.to(cuda_device)),
                                 hop_seconds=0.125, context_seconds=0.375)
        with plain_versions(plain), torch.profiler.profile(activities=activities) as prof:
            streams[plain] = [sep.push(mix[i : i + 1000]) for i in range(0, 6000, 1000)]
            torch.cuda.synchronize()
        assert _device_kernels(prof, "trunk_kernel") == (0 if plain else 6)
        assert _replay_spans(prof) == (0 if plain else 4)
    for got, want in zip(streams[False], streams[True]):
        snr = 10 * np.log10(np.square(want).sum() / max(np.square(got - want).sum(), 1e-30))
        assert snr >= SERVE_KERNEL_DB


def test_stateful_stream_on_the_card_matches_offline(cuda_device):
    """The exact stateful engine with its state on the card: the emissions
    equal the causal module's offline forward there (fp32, TF32 off)."""
    model = ConvTasNet(enc_dim=32, bottleneck=16, hidden=32, blocks=3, repeats=2, causal=True,
                       generator=torch.Generator().manual_seed(0)).to(cuda_device).eval()
    mix = (_normal((1, 4000), seed=42) * 0.1).numpy()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        est, lat = stateful_stream_separate(model, mix[0], 400)
        with torch.no_grad():
            want = model(torch.from_numpy(mix).to(cuda_device)).cpu().numpy()[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    assert est.shape == want.shape and len(lat) == 10
    np.testing.assert_allclose(est, want, rtol=1e-4, atol=1e-5)


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
    with plain_versions():
        want = cuda_apply(model, mix)
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
            with plain_versions(kind == "fp32"):
                out = tcn_trunk_train(*params, dils=dils,
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
    with pytest.raises(ValueError, match=r"needs plain_versions\(\)"):
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
            with plain_versions():
                want, want_aux = layer(x)
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
        with plain_versions():
            plain = model.codes(frames)
    assert nearest_code.launches == before + 2 + 2  # 2 deep stages, 2 skip stages of pq 4 each
    assert torch.equal(deep, plain[0]) and torch.equal(skip, plain[1])


# SepFormer's attention on the card: SDPA's flash kernel against the plain
# version on the same bf16 inputs. Both compute the scores in fp32; flash
# rounds the softmax's probabilities to bf16 before the product with V (2^-9
# relative) and sums in another order, so the output differs by a few bf16
# ulps of values near 1.
FLASH_REL = 1e-2


def _heads(sequences, length, seed, dtype=torch.bfloat16, head_dim=32, device="cuda"):
    return [_normal((sequences, 8, length, head_dim), seed=seed + i).to(device, dtype)
            for i in range(3)]


@pytest.mark.parametrize("sequences,length", [(1_296, 250), (4_000, 81), (3, 7)])
def test_flash_attention_matches_plain(cuda_device, sequences, length):
    from speech_separation_tpu_torch.ops.attention import attention, attention_plain

    q, k, v = _heads(sequences, length, 200, device=cuda_device)
    got = attention(q, k, v)
    want = attention_plain(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _rel(got, want) <= FLASH_REL
    # the head-split views the transformer layer passes (strided, not contiguous)
    qkv = _normal((sequences, length, 3, 8, 32), seed=203).to(cuda_device, torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    assert _rel(attention(q, k, v), attention_plain(q, k, v)) <= FLASH_REL


class Dispatched(TorchDispatchMode):
    """Records the name of every aten op dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_attention_runs_only_the_flash_kernel(cuda_device):
    """A call dispatches SDPA's flash op and none of another backend's (the
    math backend's products and softmax, the efficient or cuDNN kernels); an
    input flash refuses raises and dispatches none of them."""
    from speech_separation_tpu_torch.ops.attention import attention

    q, k, v = _heads(64, 250, 210, device=cuda_device)
    def other_backends(ops):
        return [op for op in ops if any(w in op for w in ("bmm", "softmax", "efficient", "cudnn"))]

    with Dispatched() as seen:
        out = attention(q, k, v)
    assert "aten._scaled_dot_product_flash_attention.default" in seen.ops, seen.ops
    assert not other_backends(seen.ops), seen.ops
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    fp32 = [t.float() for t in (q, k, v)]
    with pytest.raises(ValueError, match="bf16 or fp16"), Dispatched() as seen:
        attention(*fp32)
    assert seen.ops == []
    wide = _heads(2, 16, 211, head_dim=512, device=cuda_device)  # flash takes heads up to 256
    with pytest.raises(RuntimeError), Dispatched() as seen:
        attention(*wide)
    assert not other_backends(seen.ops) and not [op for op in seen.ops if "attention" in op]


def test_sepformer_serving_matches_the_reference(cuda_device):
    """``serving_fn(bf16=True)`` at the published widths on 2 × 4 s against
    the benchmark's fp32 reference, within the cell's ``est_rel_err`` limit;
    the fp32 module refuses to run its attention outside flash."""
    import json

    from bench_torch.reference import sepformer as reference
    from speech_separation_tpu_torch.models.sepformer import SepFormer, serving_fn

    root = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"
    cfg = json.loads((root / "configs" / "sepformer.json").read_text())
    limit = json.loads((root / "limits" / "sepformer_separate.json").read_text())["est_rel_err"]
    weights = reference.make_weights(cfg, 2**31 + 41, cuda_device)
    model = SepFormer().to(cuda_device)
    model.load_state_dict(weights)
    mix = _normal((2, 32_000), seed=212).to(cuda_device)
    got = serving_fn(model, bf16=True)(mix)
    want = reference.separate(weights, cfg, mix)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2, 32_000)
    for r in range(2):
        assert _rel(got[r], want[r]) <= limit
    with pytest.raises(ValueError, match="bf16 or fp16"):
        serving_fn(model)(mix)
    with plain_versions():  # the plain attention serves fp32 on the card
        assert _rel(serving_fn(model)(mix), want) <= 1e-4


def test_sepformer_trains_through_flash_in_bf16(cuda_device):
    """The SI-SDR PIT step's gradients with bf16 products, the attention's
    backward in flash: as near the fp32 gradients as the same step with the
    plain attention (both round every product's operands to bf16; a wrong
    backward would be off by its whole size)."""
    from speech_separation_tpu_torch.losses import pit_si_sdr_loss
    from speech_separation_tpu_torch.models.sepformer import SepFormer

    toy = dict(num_speakers=2, enc_dim=64, win=16, d_model=64, heads=2, ffn=128, layers=2,
               chunk=50, blocks=1)
    model = SepFormer(**toy, generator=torch.Generator().manual_seed(5)).to(cuda_device)
    mix = _normal((2, 8_000), seed=213).to(cuda_device)
    sources = _normal((2, 2, 8_000), seed=214).to(cuda_device)
    lengths = torch.tensor([8_000, 6_000])

    def grads(dtype):
        params = {n: p.to(dtype) for n, p in model.named_parameters()}
        est = torch.func.functional_call(model, params, (mix,))
        loss = pit_si_sdr_loss(est.float(), sources, lengths)
        return torch.autograd.grad(loss, list(model.parameters()))

    flash = grads(torch.bfloat16)
    with plain_versions():
        plain, want = grads(torch.bfloat16), grads(torch.float32)
    for f, p, w in zip(flash, plain, want):
        assert torch.isfinite(f).all() and _rel(f, w) <= max(2 * _rel(p, w), 2e-2)


# The fused residual add and LayerNorm against its plain version (x +
# y.float(), PyTorch's LayerNorm, a cast) on the same inputs. x + y is one fp32
# add on both sides: bit-identical. The statistics are summed in other orders
# (a warp's two passes over registers against PyTorch's Welford), so fp32 rows
# differ by a few fp32 ulps of their terms, and a bf16 row may round the other
# way where its fp32 value lies at a rounding boundary: one bf16 ulp. Near
# zero, where the centred term cancels against beta (|beta| up to ~5 here),
# those few fp32 ulps of the terms (~1e-6) exceed a bf16 ulp of the result, so
# the ulp is taken at no less than LN_BF16_FLOOR (a bf16 ulp of 3e-5 there).
LN_FP32_REL = 1e-6
LN_BF16_FLOOR = 2.0**-8


def _bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of the larger of |got|, |want|
    and ``LN_BF16_FLOOR``."""
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(torch.maximum(g.abs(), w.abs()),
                                     torch.full_like(g, LN_BF16_FLOOR)))
    return ((g - w).abs() / torch.ldexp(torch.ones_like(g), e - 8)).max().item()


@pytest.mark.parametrize("branch,out", [(torch.bfloat16, torch.bfloat16),
                                        (torch.bfloat16, torch.float32),
                                        (None, torch.bfloat16)],
                         ids=["add_bf16", "add_fp32", "norm_bf16"])
@pytest.mark.parametrize("rows", [1, 31, 324_000])
@pytest.mark.parametrize("dim", [256, 64])
def test_residual_layer_norm_matches_plain(cuda_device, dim, rows, branch, out):
    from speech_separation_tpu_torch.ops.layer_norm_cuda import (
        residual_layer_norm,
        residual_layer_norm_plain,
    )

    x = (3 * _normal((rows, dim), seed=220) + 0.5).to(cuda_device)
    y = None if branch is None else _normal((rows, dim), seed=221).to(cuda_device, branch)
    gamma = (1 + 0.2 * _normal((dim,), seed=222)).to(cuda_device)
    beta = _normal((dim,), seed=223).to(cuda_device)
    want_sum, want = residual_layer_norm_plain(x, y, gamma, beta, out)
    runs = []
    with torch.inference_mode():
        for dtype in (out, out, torch.float32):
            stream = x.clone()
            before = residual_layer_norm.launches
            got_sum, got = residual_layer_norm(stream, y, gamma, beta, dtype)
            assert got_sum is stream and residual_layer_norm.launches == before + 1
            runs.append((got_sum, got))
    torch.cuda.synchronize()
    (got_sum, got), (again_sum, again), (_, got32) = runs
    assert got.dtype == out and got.shape == x.shape
    assert torch.equal(got_sum, want_sum)  # in place over x where y is given
    assert torch.equal(again_sum, got_sum) and torch.equal(again, got)  # reruns bit-identical
    assert _rel(got32, residual_layer_norm_plain(x, y, gamma, beta, torch.float32)[1]) <= LN_FP32_REL
    if out == torch.bfloat16:
        assert torch.equal(got, got32.to(out))  # the kernel's fp32 rows, rounded once
        assert _bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("branch", [torch.float32, None], ids=["add_fp32_branch", "norm"])
@pytest.mark.parametrize("rows", [31, 160_000])
def test_residual_layer_norm_in_tfgridnets_form(cuda_device, rows, branch):
    """TF-GridNet's form (``models/tfgridnet.py``): an fp32 branch or none,
    rows of D = 128 channels, bf16 rows out, eps 1e-5. The rows' scales run
    from 10^-3 to 3, so the first rows' variance is near eps: the plain
    version at SepFormer's eps 1e-6 lies hundreds of bf16 ulps away, and the
    kernel must match the one at the eps it was given."""
    from speech_separation_tpu_torch.ops.layer_norm_cuda import (
        EPS,
        residual_layer_norm,
        residual_layer_norm_plain,
    )

    dim, eps, out = 128, 1e-5, torch.bfloat16
    scale = torch.logspace(-3, 0.5, rows)[:, None]
    x = (scale * (3 * _normal((rows, dim), seed=224) + 0.5)).to(cuda_device)
    y = None if branch is None else (scale * _normal((rows, dim), seed=225)).to(cuda_device, branch)
    gamma = (1 + 0.2 * _normal((dim,), seed=226)).to(cuda_device)
    beta = _normal((dim,), seed=227).to(cuda_device)
    want_sum, want = residual_layer_norm_plain(x, y, gamma, beta, out, eps)
    with torch.inference_mode():
        before = residual_layer_norm.launches
        got_sum, got = residual_layer_norm(x.clone(), y, gamma, beta, out, eps)
        assert residual_layer_norm.launches == before + 1
    torch.cuda.synchronize()
    assert got.dtype == out and torch.equal(got_sum, want_sum)
    assert _bf16_ulps(got, want) <= 1.0
    assert _bf16_ulps(got, residual_layer_norm_plain(x, y, gamma, beta, out, EPS)[1]) > 1.0


def test_residual_layer_norm_refusals(cuda_device):
    from speech_separation_tpu_torch.ops.layer_norm_cuda import (
        MAX_DIM,
        residual_layer_norm,
        residual_layer_norm_plain,
    )

    wide = torch.zeros(4, MAX_DIM + 2, device=cuda_device)
    g = torch.ones(MAX_DIM + 2, device=cuda_device)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            residual_layer_norm(wide[:, :MAX_DIM], None, g[:MAX_DIM], g[:MAX_DIM], torch.bfloat16)
        with pytest.raises(ValueError, match=f"1 to {MAX_DIM}"):
            residual_layer_norm(wide, None, g, g, torch.bfloat16)
        # the widest row it takes, an odd width (one value a chunk)
        for d in (MAX_DIM, 255):
            x = _normal((5, d), seed=224).to(cuda_device)
            want = residual_layer_norm_plain(x, None, g[:d], 0 * g[:d], torch.float32)[1]
            got = residual_layer_norm(x, None, g[:d], 0 * g[:d], torch.float32)[1]
            assert _rel(got, want) <= LN_FP32_REL


def test_sepformer_serving_norms_only_in_the_fused_kernel(cuda_device):
    """A bf16 ``serving_fn`` forward dispatches no LayerNorm op of PyTorch's
    and launches the fused kernel once a norm (blocks x 2 halves x (1 + 2 x
    layers)); under ``plain_versions()`` PyTorch's LayerNorm runs instead, to
    the same output within bf16 rounding."""
    from speech_separation_tpu_torch.models.sepformer import SepFormer, serving_fn
    from speech_separation_tpu_torch.ops.layer_norm_cuda import residual_layer_norm

    toy = dict(num_speakers=2, enc_dim=64, win=16, d_model=64, heads=2, ffn=128, layers=2,
               chunk=50, blocks=2)
    model = SepFormer(**toy, generator=torch.Generator().manual_seed(6)).to(cuda_device)
    mix = _normal((2, 8_000), seed=225).to(cuda_device)
    serve = serving_fn(model, bf16=True)
    before = residual_layer_norm.launches
    with Dispatched() as seen:
        got = serve(mix)
    torch.cuda.synchronize()
    assert residual_layer_norm.launches - before == 2 * 2 * (1 + 2 * 2)
    assert not [op for op in seen.ops if "layer_norm" in op], seen.ops
    with plain_versions(), Dispatched() as seen:
        want = serve(mix)
    # under inference mode the mode sees aten.layer_norm before it decomposes
    assert len([op for op in seen.ops if "layer_norm" in op]) == 2 * 2 * (1 + 2 * 2), seen.ops
    # the two differ where a normed row rounds to the other bf16 neighbour (a
    # fraction of the rows, one ulp each), carried through bf16 products: below
    # the bf16 path's own distance from fp32 (~1e-2 at the published widths)
    assert _rel(got, want) <= 2e-2


# TF-GridNet's attention scores on the card: the wide-head kernel against the
# plain version (fp32 scores and softmax) on the same bf16 inputs. Both sum the
# scores in fp32, in other orders (~1e-6 of |s|, ~1e-5 at the scales here);
# the kernel rounds each probability once to bf16 (2^-9 relative), so each
# element is within 2^-8 of the plain one relative to its size, past a floor
# of 1e-6 for the smallest.
SCORES_REL = 2.0**-8
SCORES_FLOOR = 1e-6


def _wide(items, length, depth, seed, device, offset=0):
    """bf16 [items, length, depth] from the seed, scores spread by a factor of 3;
    ``offset`` elements into a flat buffer (a pointer 2 bytes off 8-byte alignment)."""
    n = items * length * depth
    flat = torch.empty(n + offset, dtype=torch.bfloat16, device=device)
    flat[offset:] = (3 * _normal((n,), seed=seed)).to(device, torch.bfloat16)
    return flat[offset:].view(items, length, depth)


@pytest.mark.parametrize("items,length,depth,offset", [(16, 1_253, 516, 0), (8, 501, 516, 0),
                                                       (5, 7, 516, 0), (6, 131, 37, 0),
                                                       (4, 65, 516, 1)],
                         ids=["L1253", "L501", "L7", "odd_width", "misaligned"])
def test_wide_attention_scores_match_plain(cuda_device, items, length, depth, offset):
    from speech_separation_tpu_torch.ops.wide_attention_cuda import (
        wide_attention_scores,
        wide_attention_scores_plain,
    )

    q = _wide(items, length, depth, 230, cuda_device, offset)
    k = _wide(items, length, depth, 231, cuda_device, offset)
    before = wide_attention_scores.launches
    with torch.inference_mode():
        got = wide_attention_scores(q, k)
        again = wide_attention_scores(q, k)
    torch.cuda.synchronize()
    assert wide_attention_scores.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (items, length, length)
    assert torch.equal(got, again)  # reruns bit-identical
    want = wide_attention_scores_plain(q, k)
    excess = (got.float() - want).abs() - SCORES_REL * want - SCORES_FLOOR
    assert excess.max().item() <= 0.0
    # each row's fp32 probabilities sum to 1 before their one rounding to bf16
    assert (got.float().sum(-1) - 1).abs().max().item() <= 2.0**-8


def test_wide_attention_matches_plain_and_refuses(cuda_device):
    from speech_separation_tpu_torch.ops.wide_attention_cuda import (
        wide_attention,
        wide_attention_plain,
        wide_attention_scores,
    )

    q = _wide(8, 301, 516, 232, cuda_device)
    k = _wide(8, 301, 516, 233, cuda_device)
    v = _wide(8, 301, 4_128, 234, cuda_device)
    with torch.inference_mode():
        got = wide_attention(q, k, v)
    assert got.dtype == torch.bfloat16 and got.shape == v.shape
    assert _rel(got, wide_attention_plain(q, k, v)) <= 1e-2  # P and the product in bf16
    with torch.inference_mode():
        with pytest.raises(TypeError, match="takes bf16"):
            wide_attention_scores(q.float(), k.float())
        with pytest.raises(ValueError, match="of one shape"):
            wide_attention_scores(q, k[:, :300])
        with pytest.raises(ValueError, match="one CUDA device"):
            wide_attention_scores(q, k.cpu())
    with pytest.raises(RuntimeError, match="no backward"):
        wide_attention_scores(q.clone().requires_grad_(True), k)


@pytest.mark.parametrize("rows,steps", [(2_064, 1_250), (20_048, 126)], ids=["inter", "intra"])
def test_lstm_recurrence_at_tfgridnets_width(cuda_device, rows, steps):
    """Row 2 at H = 256 in bf16 over a 16 x 10 s batch's sub-band rows (16 x
    129 bins of 1,250 windows) and intra-frame rows (16 x 1,253 frames of 126
    windows), one launch a row slice of at most 1,024 rows."""
    hidden = 256
    gen = torch.Generator(device=cuda_device).manual_seed(235)
    xw = 0.5 * torch.randn(2, rows, steps, 4 * hidden, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16)
    u = (torch.randn(2, hidden, 4 * hidden, generator=gen, device=cuda_device) / hidden**0.5
         ).to(torch.bfloat16)
    plan = forward_plan(rows, hidden, True, 2, **_lstm_limits(cuda_device))
    before = lstm_recurrence.launches
    got = lstm_recurrence(xw, u, reverse=(False, True))
    torch.cuda.synchronize()
    assert lstm_recurrence.launches - before == len(plan.slices) == -(-rows // 1_024)
    want = lstm_recurrence_plain(xw, u, reverse=(False, True))
    assert (got.float() - want.float()).abs().max().item() <= LSTM_BF16_ATOL


def test_stft_kernel_with_the_sqrt_hann_window(cuda_device):
    x = _normal((16, 80_000), seed=236).to(cuda_device)
    got = stft_cuda(x, 256, 64, window="sqrt_hann")
    want = stft(x, 256, 64, window="sqrt_hann")
    assert got.shape == want.shape == (16, 1_253, 129)
    assert (got - want).abs().max().item() <= STFT_ATOL
    assert (got - stft(x, 256, 64, method="fft", window="sqrt_hann")).abs().max().item() <= STFT_ATOL


def test_tfgridnet_serving_matches_the_reference(cuda_device):
    """``serving_fn(bf16=True)`` at the published widths on 2 × 4 s against
    the benchmark's fp32 reference, within the cell's ``est_rel_err`` limit:
    the BiLSTMs in row 2, each norm over the channels in the fused kernel,
    each block's attention in one scores launch; the fp32 module refuses to
    run its attention outside the kernel."""
    import json

    from bench_torch.reference import tfgridnet as reference
    from speech_separation_tpu_torch.models.tfgridnet import TFGridNet, serving_fn
    from speech_separation_tpu_torch.ops.layer_norm_cuda import residual_layer_norm
    from speech_separation_tpu_torch.ops.wide_attention_cuda import wide_attention_scores

    root = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"
    cfg = json.loads((root / "configs" / "tfgridnet.json").read_text())
    limit = json.loads((root / "limits" / "tfgridnet_separate.json").read_text())["est_rel_err"]
    weights = reference.make_weights(cfg, 2**31 + 43, cuda_device)
    model = TFGridNet().to(cuda_device)
    model.load_state_dict(weights)
    mix = _normal((2, 32_000), seed=237).to(cuda_device)
    counters = (lstm_recurrence, residual_layer_norm, wide_attention_scores)
    before = [c.launches for c in counters]
    with Dispatched() as seen:
        got = serving_fn(model, bf16=True)(mix)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    # 2 x 503 intra rows and 2 x 129 inter rows: one slice each, a block
    assert launched == [2 * cfg["blocks"], 2 * cfg["blocks"], cfg["blocks"]]
    assert not [op for op in seen.ops if "layer_norm" in op or "attention" in op], seen.ops
    want = reference.separate(weights, cfg, mix)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 2, 32_000)
    for r in range(2):
        assert _rel(got[r], want[r]) <= limit
    with pytest.raises(TypeError, match="takes bf16"):
        serving_fn(model)(mix)
    with plain_versions():  # the plain attention serves fp32 on the card
        assert _rel(serving_fn(model)(mix), want) <= 1e-4


# The mask-and-decode kernel against its plain version on the same bf16
# operands: both add the mask's bias, take the sigmoid and the product in fp32
# and round v once to bf16, then sum exact products in fp32, in other orders
# (~1e-6 relative). A sigmoid an fp32 ulp apart can flip one v's rounding: 2^-8
# of one of a sample's 2·N terms. So 1e-4 relative L2, and each sample within a
# bf16 ulp of the largest.
MASK_DECODE_REL = 1e-4


def _mask_decode_operands(batch, frames, channels, win, device):
    bf16 = torch.bfloat16
    feats = torch.relu(_normal((batch, channels, frames), seed=242)).to(device, bf16)
    return ((_normal((batch, frames, 2 * channels), seed=240)).to(device, bf16),
            (0.1 * _normal((2 * channels,), seed=241)).to(device, bf16),
            feats.transpose(1, 2),  # the encoder's layout: a view of [B, N, K]
            (_normal((win, channels, 1), seed=243) / np.sqrt(channels)).to(device, bf16),
            (0.1 * _normal((1,), seed=244)).to(device, bf16))


@pytest.mark.parametrize("batch,frames,channels,win,short", [
    (1, 800, 256, 40, 0), (16, 3_200, 256, 40, 0), (3, 131, 64, 16, 5), (2, 77, 512, 64, 31),
    (1, 90, 24, 20, 0)], ids=["cell_hop", "bulk_16x8s", "odd_frames", "widest", "n24"])
def test_mask_decode_kernel_matches_plain(cuda_device, batch, frames, channels, win, short):
    """At the ``tasnet_stream`` cell's window (1 × 800 frames × 512 logits), a
    bulk 16 × 8 s batch, a ragged K with a trimmed tail, the widest N and win
    (past 48 KB of shared memory), and an N that leaves half a 16-channel step
    of zeros."""
    from speech_separation_tpu_torch.ops.mask_decode_cuda import mask_decode, mask_decode_plain

    ops = _mask_decode_operands(batch, frames, channels, win, cuda_device)
    samples = frames * (win // 2) - short
    want = mask_decode_plain(*ops, samples)
    with torch.inference_mode():
        before = mask_decode.launches
        got = mask_decode(*ops, samples)
        again = mask_decode(*ops, samples)
        assert mask_decode.launches == before + 2
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (batch, 2, samples)
    assert torch.equal(again, got)  # reruns bit-identical
    assert _rel(got, want) <= MASK_DECODE_REL
    assert (got - want).abs().max().item() <= 2.0**-8 * want.abs().max().item()


def test_mask_decode_kernel_refusals(cuda_device):
    from speech_separation_tpu_torch.ops.mask_decode_cuda import mask_decode

    logits, mask_b, feats, dec_k, dec_b = _mask_decode_operands(1, 64, 64, 40, cuda_device)
    before = mask_decode.launches
    flat = torch.zeros(1 + logits.numel(), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mask_decode(flat[1:].view(logits.shape), mask_b, feats, dec_k, dec_b, 64 * 20)
    with pytest.raises(ValueError, match="contiguous"):
        mask_decode(logits, mask_b, feats.contiguous(), dec_k, dec_b, 64 * 20)
    with pytest.raises(ValueError, match="one CUDA device"):
        mask_decode(logits, mask_b, feats, dec_k.cpu(), dec_b, 64 * 20)
    with pytest.raises(RuntimeError, match="forward only"):
        mask_decode(logits.requires_grad_(), mask_b, feats, dec_k, dec_b, 64 * 20)
    with pytest.raises(TypeError, match="bf16"):
        mask_decode(logits.detach().float(), mask_b, feats, dec_k, dec_b, 64 * 20)
    assert mask_decode.launches == before


def test_window_stream_decodes_in_the_kernel_once_a_hop(cuda_device):
    """The window engine over ``cuda_apply`` at the ``tasnet_stream`` cell's
    widths, hop and context: one ``mask_decode`` launch a hop and no cuDNN
    ``dgrad`` kernel (the transposed conv it replaces); each hop's estimate
    within the cell's ``hop_rel_err`` limit of the one ``plain_versions()``
    gives."""
    import json

    from bench_torch.programs import conv_tasnet as program
    from bench_torch.reference import conv_tasnet as reference

    root = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"
    cfg = json.loads((root / "configs" / "conv_tasnet.json").read_text())
    limit = json.loads((root / "limits" / "tasnet_stream.json").read_text())["hop_rel_err"]
    model = program.build(cfg, reference.make_weights(cfg, 2**31 + 45, cuda_device), cuda_device)
    hop, hops = 4_000, 5
    mix = (_normal((hops * hop,), seed=245) * 0.3).numpy()
    streams = {}
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for plain in (False, True):
        sep = StreamingSeparator(lambda m: cuda_apply(model, m.to(cuda_device)), hop_seconds=0.5,
                                 context_seconds=1.5)
        with plain_versions(plain), torch.profiler.profile(activities=activities) as prof:
            streams[plain] = [sep.push(mix[i * hop:(i + 1) * hop]) for i in range(hops)]
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert not [k for k in kernels if "dgrad" in k], kernels
        fused = [k for k in kernels if "mask_decode" in k]
        assert len(fused) == (0 if plain else hops), kernels
        assert _replay_spans(prof) == (0 if plain else hops - 2)
    for got, want in zip(streams[False], streams[True]):
        assert got.shape == want.shape == (2, hop)
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= limit


# cuda_apply's CUDA graph (models/tasnet_serving.py): at the tasnet_stream
# cell's widths and window ([1, 16,000] samples: 1.5 s of context and a 0.5 s
# hop at 8 kHz), inside ops.fixed_shape_calls() a key's second call in a row
# captures and later calls replay the same kernels on the same operands, so
# each result equals the eager chain (tasnet_serving._launch) bit for bit.
GRAPH_WINDOW = 16_000
REPLAY_SPAN = "sst.tasnet.graph.replay"
WITH_DEVICE = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def _stream_cell_model(device, seed=2**31 + 251):
    import json

    from bench_torch.programs import conv_tasnet as program
    from bench_torch.reference import conv_tasnet as reference

    root = pathlib.Path(__file__).resolve().parents[1] / "bench_torch"
    cfg = json.loads((root / "configs" / "conv_tasnet.json").read_text())
    return program.build(cfg, reference.make_weights(cfg, seed, device), device), cfg


def _launch_counts():
    from speech_separation_tpu_torch.ops.mask_decode_cuda import mask_decode

    return tcn_trunk_cuda.launches, mask_decode.launches


def _replay_spans(prof) -> int:
    return sum(e.name == REPLAY_SPAN for e in prof.events())


def _device_kernels(prof, name: str) -> int:
    return sum(name in e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def test_cuda_apply_replays_equal_eager_calls_window_for_window(cuda_device):
    """Ten windows in a row: eager, captured, then eight replays, each equal
    to the eager chain on its window, each returned tensor unchanged by the
    calls after it, each replay one run of the trunk and of ``mask_decode``
    on the device and no call of their wrappers, one graph held."""
    from speech_separation_tpu_torch.models import tasnet_serving as serving
    from speech_separation_tpu_torch.ops import fixed_shape_calls

    model, _ = _stream_cell_model(cuda_device)
    windows = (_normal((10, GRAPH_WINDOW), seed=250) * 0.3).to(cuda_device)
    outs, kept = [], []
    for i in range(10):
        before = _launch_counts()
        with fixed_shape_calls(), torch.profiler.profile(activities=WITH_DEVICE) as prof:
            got = cuda_apply(model, windows[i:i + 1])
            torch.cuda.synchronize()
        # the eager call, the capture's warm-up and the capture call the wrappers
        calls = {0: 1, 1: 2}.get(i, 0)
        assert _launch_counts() == (before[0] + calls, before[1] + calls)
        assert _replay_spans(prof) == (i >= 2)
        assert _device_kernels(prof, "trunk_kernel") == 1
        assert _device_kernels(prof, "mask_decode") == 1
        outs.append(got)
        kept.append(got.clone())
    w = serving._serving(model)
    assert w.graphs.graph is not None
    for i, (got, first) in enumerate(zip(outs, kept)):
        assert torch.equal(got, first)  # not overwritten by a later replay
        assert torch.equal(got, serving._launch(model, w, windows[i:i + 1]))


def test_cuda_apply_recaptures_after_an_in_place_update(cuda_device):
    """An optimizer's ``add_`` under ``no_grad``: a new entry, eager, then a
    new capture, equal to a model never served with the new weights."""
    from bench_torch.programs import conv_tasnet as program
    from speech_separation_tpu_torch.models import tasnet_serving as serving
    from speech_separation_tpu_torch.ops import fixed_shape_calls

    model, cfg = _stream_cell_model(cuda_device)
    window = (_normal((1, GRAPH_WINDOW), seed=252) * 0.3).to(cuda_device)
    with fixed_shape_calls():
        for _ in range(3):
            cuda_apply(model, window)
        old = serving._SERVING[model][1]
        assert old.graphs.graph is not None
        with torch.no_grad():
            model.decoder.bias.add_(0.05)
        outs = [cuda_apply(model, window) for _ in range(4)]
    new = serving._SERVING[model][1]
    assert new is not old and new.graphs.graph is not None
    fresh = program.build(cfg, model.state_dict(), cuda_device)
    want = serving._launch(fresh, serving._serving(fresh), window)
    for got in outs:
        assert torch.equal(got, want)
    assert not torch.equal(outs[0], serving._launch(model, old, window))


def test_cuda_apply_runs_a_new_shape_eager_and_plain_versions_never_replay(cuda_device):
    from speech_separation_tpu_torch.models import tasnet_serving as serving
    from speech_separation_tpu_torch.ops import fixed_shape_calls

    model, _ = _stream_cell_model(cuda_device)
    window = (_normal((1, GRAPH_WINDOW), seed=253) * 0.3).to(cuda_device)
    short = window[:, :8_000].clone()
    activities = [torch.profiler.ProfilerActivity.CPU]
    with fixed_shape_calls():
        for _ in range(3):
            cuda_apply(model, window)
        w = serving._serving(model)
        held = w.graphs.graph
        with torch.profiler.profile(activities=activities) as prof:
            got = cuda_apply(model, short)  # a new shape: eager, no capture
        assert _replay_spans(prof) == 0 and w.graphs.graph is held
        assert torch.equal(got, serving._launch(model, w, short))
        before = _launch_counts()
        with torch.profiler.profile(activities=activities) as prof, plain_versions():
            plain = [cuda_apply(model, window) for _ in range(3)]
        assert _replay_spans(prof) == 0 and _launch_counts() == before
        assert w.graphs.graph is held
        with plain_versions():
            assert torch.equal(plain[0], serving._launch(model, w, window))
        with torch.profiler.profile(activities=activities) as prof:
            again = cuda_apply(model, window)  # the window's graph is still held
    assert _replay_spans(prof) == 1
    assert torch.equal(again, serving._launch(model, w, window))


def test_cuda_apply_outside_fixed_shape_calls_never_captures(cuda_device):
    """Bulk calls of one shape back to back stay eager: every call runs the
    wrappers, no replay, no key remembered."""
    from speech_separation_tpu_torch.models import tasnet_serving as serving

    model, _ = _stream_cell_model(cuda_device)
    batch = (_normal((4, GRAPH_WINDOW), seed=255) * 0.3).to(cuda_device)
    before = _launch_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [cuda_apply(model, batch) for _ in range(4)]
    assert _replay_spans(prof) == 0 and _launch_counts() == (before[0] + 4, before[1] + 4)
    w = serving._serving(model)
    assert w.graphs.last is None and w.graphs.graph is None
    for got in outs:
        assert torch.equal(got, outs[0])


@pytest.mark.parametrize("captured_in_inference_mode", [True, False])
def test_cuda_apply_replays_across_inference_mode(cuda_device, captured_in_inference_mode):
    """A window captured under ``torch.inference_mode()`` (a stream's calls)
    replays for a plain call on the same shape, and the other way round."""
    from speech_separation_tpu_torch.models import tasnet_serving as serving
    from speech_separation_tpu_torch.ops import fixed_shape_calls

    model, _ = _stream_cell_model(cuda_device)
    windows = (_normal((4, GRAPH_WINDOW), seed=254) * 0.3).to(cuda_device)
    with torch.inference_mode(captured_in_inference_mode), fixed_shape_calls():
        for i in range(2):
            cuda_apply(model, windows[i:i + 1])
    w = serving._serving(model)
    assert w.graphs.graph is not None
    for i in (2, 3):
        with torch.inference_mode(i == 2 and not captured_in_inference_mode), fixed_shape_calls(), \
                torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = cuda_apply(model, windows[i:i + 1])
        assert _replay_spans(prof) == 1
        assert torch.equal(got, serving._launch(model, w, windows[i:i + 1]))
