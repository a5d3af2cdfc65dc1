"""PyTorch port, DSP and recurrence ops against the JAX reference on the CPU.

Inputs come from seeded numpy and cross to both frameworks as arrays. The
port's CUDA wrappers take their plain versions for CPU tensors; the JAX Pallas
kernels run in interpret mode off-TPU. The kernels themselves are compared
with their plain versions on a GPU in ``test_torch_cuda.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models.blstm import LSTM as JaxLSTM
from speech_separation_tpu.models.blstm import BiLSTM as JaxBiLSTM
from speech_separation_tpu.ops.lstm_pallas import lstm_pallas
from speech_separation_tpu.ops.stft_pallas import stft_pallas
from speech_separation_tpu_torch.models.blstm import LSTM, BiLSTM
from speech_separation_tpu_torch.ops import features, framing, quant, stft, windows
from speech_separation_tpu_torch.ops.lstm_cuda import lstm_recurrence, lstm_recurrence_plain
from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda
from speech_separation_tpu_torch.weights import flatten_params

# the JAX ops package re-exports functions under its module names (ops.stft)
jfeatures, jframing, jquant, jstft, jwindows = (
    importlib.import_module(f"speech_separation_tpu.ops.{name}")
    for name in ("features", "framing", "quant", "stft", "windows")
)

DSP_ATOL = 1e-4  # the JAX package's own STFT bound (tests/test_pallas_kernels.py)
LSTM_ATOL = 1e-5  # fp32 recurrence, the JAX lstm_pallas test's bound

SIGNALS = {
    "batched": (2, 5000),
    "one_d": (12345,),
    "odd_length": (3, 4097),
}


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("size,shift,window_length", [(256, 128, None), (512, 128, None), (256, 64, 200)])
def test_windows_equal_jax_exactly(size, shift, window_length):
    np.testing.assert_array_equal(windows.blackman(size), jwindows.blackman(size))
    np.testing.assert_array_equal(
        windows.analysis_window(size, window_length), jwindows.analysis_window(size, window_length)
    )
    np.testing.assert_array_equal(
        windows.biorthogonal_synthesis_window(size, shift, window_length),
        jwindows.biorthogonal_synthesis_window(size, shift, window_length),
    )


def test_framing_and_overlap_add_match_jax():
    x = _signal((3, 128 * 9))
    got = framing.frame_signal(torch.from_numpy(x), 256, 128).numpy()
    want = np.asarray(jframing.frame_signal(jnp.asarray(x), 256, 128))
    np.testing.assert_array_equal(got, want)
    frames = _signal((2, 7, 256), seed=1)
    got = framing.overlap_add(torch.from_numpy(frames), 128).numpy()
    want = np.asarray(jframing.overlap_add(jnp.asarray(frames), 128))
    np.testing.assert_array_equal(got, want)
    assert framing.num_frames(64256, 256, 128) == jframing.num_frames(64256, 256, 128) == 501
    assert framing.num_samples(501, 256, 128) == jframing.num_samples(501, 256, 128)


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("kind", sorted(SIGNALS))
def test_stft_matches_jax(method, kind):
    x = _signal(SIGNALS[kind])
    got = stft.stft(torch.from_numpy(x), 256, 128, method=method).numpy()
    want = np.asarray(jstft.stft(jnp.asarray(x), 256, 128, method=method))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.real, want.real, atol=DSP_ATOL)
    np.testing.assert_allclose(got.imag, want.imag, atol=DSP_ATOL)


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_istft_matches_jax(method):
    spec = np.array(jstft.stft(jnp.asarray(_signal((2, 3000))), 256, 128))
    got = stft.istft(torch.from_numpy(spec), 256, 128, method=method).numpy()
    want = np.asarray(jstft.istft(jnp.asarray(spec), 256, 128, method=method))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=DSP_ATOL)


def test_stft_frame_count_and_bases_match_jax():
    for samples in (1, 4097, 64000):
        for fading in (True, False):
            assert stft.stft_frame_count(samples, 256, 128, fading) == jstft.stft_frame_count(
                samples, 256, 128, fading
            )
    np.testing.assert_array_equal(
        stft.analysis_basis(256).numpy(), np.asarray(jstft.analysis_basis(256))
    )
    np.testing.assert_array_equal(
        stft.synthesis_basis(256, 128).numpy(), np.asarray(jstft.synthesis_basis(256, 128))
    )


@pytest.mark.parametrize("kind", ["batched", "one_d"])
def test_stft_cuda_plain_path_matches_stft_pallas(kind):
    x = _signal((2, 6000) if kind == "batched" else (4001,), seed=2)
    got = stft_cuda(torch.from_numpy(x)).numpy()
    want = np.asarray(stft_pallas(jnp.asarray(x), tile_frames=32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.real, want.real, atol=DSP_ATOL)
    np.testing.assert_allclose(got.imag, want.imag, atol=DSP_ATOL)


def test_magnitude_angle_matches_jax():
    spec = np.array(jstft.stft(jnp.asarray(_signal((2, 2000))), 256, 128))
    spec[0, 3] = 0.0  # a silent frame exercises the epsilon floor
    got = features.magnitude_angle(torch.from_numpy(spec))
    want = jfeatures.magnitude_angle(jnp.asarray(spec))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_int16_quantization_matches_jax():
    rng = np.random.default_rng(3)
    pcm16 = rng.integers(-32768, 32768, (2, 100), dtype=np.int16)
    pcm32 = rng.integers(-70000, 70000, (2, 100), dtype=np.int32)
    for pcm in (pcm16, pcm32):
        np.testing.assert_array_equal(
            quant.dequant_i16(torch.from_numpy(pcm)).numpy(),
            np.asarray(jquant.dequant_i16(jnp.asarray(pcm))),
        )
    wave = (rng.standard_normal((2, 3, 500)) * np.array([0.3, 2.5, 7.0])[:, None]).astype(np.float32)
    codes, scale = quant.quantize_estimates_i16(torch.from_numpy(wave))
    jcodes, jscale = jquant.quantize_estimates_i16(jnp.asarray(wave))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        quant.dequantize_estimates_i16(codes.numpy(), scale.numpy()),
        jquant.dequantize_estimates_i16(np.asarray(jcodes), np.asarray(jscale)),
    )


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_recurrence_plain_matches_lstm_pallas(reverse):
    rng = np.random.default_rng(4)
    b, t, h = 3, 37, 12
    xw = rng.standard_normal((b, t, 4 * h)).astype(np.float32)
    u = (rng.standard_normal((h, 4 * h)) / np.sqrt(h)).astype(np.float32)
    seq = xw[:, ::-1] if reverse else xw
    want = np.asarray(
        lstm_pallas(jnp.asarray(seq), jnp.asarray(u), tile_t=8, interpret=True,
                    compute_dtype=jnp.float32)
    )
    if reverse:
        want = want[:, ::-1]
    got = lstm_recurrence(
        torch.from_numpy(xw)[None], torch.from_numpy(u)[None], reverse=(reverse,)
    ).numpy()
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL)


def test_lstm_module_matches_jax_lstm():
    x = _signal((3, 29, 7), seed=5)
    jmodel = JaxLSTM(features=12)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = LSTM(7, 12)
    model.load_state_dict(flatten_params(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL)


def test_bilstm_both_directions_match_jax_bilstm():
    x = _signal((2, 23, 5), seed=6)
    jmodel = JaxBiLSTM(features=8)
    params = jmodel.init(jax.random.key(1), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = BiLSTM(5, 8)
    model.load_state_dict(flatten_params(jax.tree.map(np.asarray, params)))
    assert tuple(model.cells.kernel.shape) == (2, 5, 32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_plain = model(torch.from_numpy(x), plain=True).numpy()
    np.testing.assert_allclose(got, want, atol=LSTM_ATOL)
    np.testing.assert_array_equal(got, got_plain)


def test_lstm_keras_init():
    model = LSTM(6, 5, directions=2, generator=torch.Generator().manual_seed(0))
    bias = model.bias.detach().numpy()
    np.testing.assert_array_equal(bias[:, 5:10], 1.0)
    np.testing.assert_array_equal(np.delete(bias, np.s_[5:10], axis=1), 0.0)
    for d in range(2):  # orthogonal recurrent kernel [H, 4H]: orthonormal rows
        u = model.recurrent_kernel[d].detach().numpy()
        np.testing.assert_allclose(u @ u.T, np.eye(5), atol=1e-5)
    limit = np.sqrt(6.0 / (6 + 20))  # glorot uniform
    assert np.abs(model.kernel.detach().numpy()).max() <= limit


def test_kernel_wrappers_reject_other_devices_and_shapes():
    x = torch.zeros(2, 4000, device="meta")
    with pytest.raises(ValueError):
        stft_cuda(x)
    xw = torch.zeros(2, 1, 3, 16, device="meta")
    with pytest.raises(ValueError):
        lstm_recurrence(xw, torch.zeros(2, 4, 16, device="meta"), reverse=(False, True))
    with pytest.raises(ValueError):
        lstm_recurrence_plain(torch.zeros(2, 1, 3, 16), torch.zeros(2, 4, 12), reverse=(False, True))
    with pytest.raises(ValueError):
        lstm_recurrence_plain(torch.zeros(2, 1, 3, 16), torch.zeros(2, 4, 16), reverse=(False,))
