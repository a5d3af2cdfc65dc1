"""PyTorch port, CUDA kernels against their plain versions on a GPU.

Every test here is marked ``cuda`` and skips where there is no GPU. The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda -q
"""

import pathlib

import numpy as np
import pytest
import torch

from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.ops.lstm_cuda import lstm_recurrence, lstm_recurrence_plain
from speech_separation_tpu_torch.ops.stft import stft
from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda
from speech_separation_tpu_torch.separate.pipeline import make_separate_fn

pytestmark = pytest.mark.cuda

STFT_ATOL = 1e-4  # fp32 FMA against cuBLAS fp32, sums in another order
LSTM_ATOL = 1e-4  # fp32 kernel against the fp32 plain loop
LSTM_BF16_ATOL = 3e-2  # bf16 operands, fp32 carry, against the fp32 plain loop
PATH_REL = 1e-4  # relative L2 of the fp32 separation output


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
