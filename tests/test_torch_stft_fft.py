"""PyTorch port: the STFT kernel's real-FFT algorithm against the JAX package on the CPU.

``stft_fft_plain`` repeats ``csrc/stft_analysis.cu``'s decomposition (the
host twiddle table, Stockham radix-4 stages, the split step, the fade offset
folded into the index of the unpadded signal). Here it is held against the
JAX package's matmul STFT and its Pallas kernel in interpret mode, loaded as
``tests/test_torch_ops.py`` loads them. The kernel itself is compared with
this plain version on a GPU in ``test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speech_separation_tpu.ops.stft_pallas import stft_pallas
from speech_separation_tpu_torch.ops.stft import stft
from speech_separation_tpu_torch.ops.stft_cuda import (
    KERNEL_SIZES,
    fft_table,
    stft_cuda,
    stft_fft_plain,
)

jstft, jwindows = (
    importlib.import_module(f"speech_separation_tpu.ops.{name}") for name in ("stft", "windows")
)

DSP_ATOL = 1e-4  # the JAX package's own STFT bound (tests/test_pallas_kernels.py)
# fp32 rounding of a float64 value: half an ulp, 2^-24 relative to values <= 1
TABLE_ATOL = 2.0**-24


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _assert_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.real.numpy(), want.real, atol=DSP_ATOL)
    np.testing.assert_allclose(got.imag.numpy(), want.imag, atol=DSP_ATOL)


@pytest.mark.parametrize("size", KERNEL_SIZES)
def test_fft_table_is_float64_rounded_once(size):
    table = fft_table(size).numpy().astype(np.float64)
    assert table.shape == (3 * size,)
    np.testing.assert_allclose(table[:size], jwindows.analysis_window(size), rtol=0, atol=TABLE_ATOL)
    k = np.arange(size, dtype=np.float64)
    twiddles = table[size:].reshape(size, 2)
    np.testing.assert_allclose(twiddles[:, 0], np.cos(2 * np.pi * k / size), rtol=0, atol=TABLE_ATOL)
    np.testing.assert_allclose(twiddles[:, 1], -np.sin(2 * np.pi * k / size), rtol=0, atol=TABLE_ATOL)


@pytest.mark.parametrize("fading", [True, False])
@pytest.mark.parametrize("size", KERNEL_SIZES)
def test_stft_fft_plain_matches_jax_matmul(size, fading):
    for samples in (4097, 12345):  # ragged: no whole number of frames
        x = _signal((2, samples), seed=size + samples)
        got = stft_fft_plain(torch.from_numpy(x), size, size // 2, fading=fading)
        _assert_close(got, jstft.stft(jnp.asarray(x), size, size // 2, fading=fading))


@pytest.mark.parametrize("fading", [True, False])
@pytest.mark.parametrize("size", [16, 64, 256, 1024])
def test_stft_fft_plain_matches_stft_pallas(size, fading):
    x = _signal((2, 4097), seed=size)
    got = stft_fft_plain(torch.from_numpy(x), size, size // 2, fading=fading)
    _assert_close(got, stft_pallas(jnp.asarray(x), size, size // 2, fading=fading, tile_frames=32))


@pytest.mark.parametrize("shift", [32, 64, 256])  # overlap 8, 4 and none
def test_stft_fft_plain_other_shifts_match_jax(shift):
    x = _signal((3, 5001), seed=shift)
    got = stft_fft_plain(torch.from_numpy(x), 256, shift)
    _assert_close(got, jstft.stft(jnp.asarray(x), 256, shift))


def test_stft_fft_plain_one_d_signal_matches_jax():
    x = _signal((12345,), seed=7)
    got = stft_fft_plain(torch.from_numpy(x))
    assert got.dim() == 2
    _assert_close(got, jstft.stft(jnp.asarray(x), 256, 128))


def test_stft_fft_plain_short_signal_matches_jax():
    x = _signal((2, 100), seed=8)  # shorter than one frame: fade pads and zeros only
    _assert_close(stft_fft_plain(torch.from_numpy(x)), jstft.stft(jnp.asarray(x), 256, 128))


def test_stft_cuda_on_the_cpu_is_still_the_matmul_plain_version():
    x = torch.from_numpy(_signal((2, 6000), seed=9))
    torch.testing.assert_close(stft_cuda(x), stft(x, method="matmul"), rtol=0, atol=0)


@pytest.mark.parametrize("size,shift", [(320, 160), (2048, 1024), (8, 4), (256, 96)])
def test_stft_fft_plain_refuses_what_the_kernel_refuses(size, shift):
    with pytest.raises(ValueError, match=f"size {size}" if size != 256 else "shift 96"):
        stft_fft_plain(torch.zeros(2, 1000), size, shift)
