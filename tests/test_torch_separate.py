"""PyTorch port, wave-to-wave separation against the JAX reference on the CPU,
plus the port's isolation from JAX and its kernel build command."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from speech_separation_tpu.data.fixture import make_synthetic_fixture as jax_fixture
from speech_separation_tpu.models import UPitBlstm as JaxUPitBlstm
from speech_separation_tpu.separate import pipeline as jpipeline
from speech_separation_tpu_torch import _build
from speech_separation_tpu_torch.data.audio_io import audiowrite, quantize_i16
from speech_separation_tpu_torch.data.datasets import WaveformLoader, prefetch_to_device, to_host
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.ops.quant import dequantize_estimates_i16
from speech_separation_tpu_torch.separate import pipeline
from speech_separation_tpu_torch.weights import upit_blstm_state_dict

ATOL = 1e-4  # fp32 STFT → network → iSTFT, the JAX DSP bound
LSB = 2  # written int16 wavs: peak-normalised then truncated, so float noise flips an LSB
FIXTURE = dict(utterances_per_split=2, min_seconds=0.4, max_seconds=1.1, seed=5)
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("torch_fixture"), **FIXTURE)


@pytest.fixture(scope="module")
def models():
    jmodel = JaxUPitBlstm(input_size=129, output_size=129, hidden=8, num_layers=1)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 4, 129)))["params"]
    model = UPitBlstm(input_size=129, output_size=129, hidden=8, num_layers=1).eval()
    model.load_state_dict(upit_blstm_state_dict(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def _ragged_batch(fixture_tree, int16: bool):
    batch = next(iter(WaveformLoader(fixture_tree / "tr", batch_size=2, transfer_int16=int16)))
    assert batch.frame_lengths[0] != batch.frame_lengths[1]  # ragged lengths
    return batch


def test_fixture_is_byte_identical_to_jax(fixture_tree, tmp_path):
    want = jax_fixture(tmp_path / "jax", **FIXTURE)
    files = sorted(p.relative_to(want) for p in want.rglob("*") if p.is_file())
    got = sorted(p.relative_to(fixture_tree) for p in fixture_tree.rglob("*") if p.is_file())
    assert got == files and len(files) == 2 + 3 * 2 * 3 + 1
    for rel in files:
        assert (fixture_tree / rel).read_bytes() == (want / rel).read_bytes(), rel


@pytest.mark.parametrize("kind", ["float", "int16", "quantize_output"])
def test_make_separate_fn_matches_jax(fixture_tree, models, kind):
    jmodel, params, model = models
    batch = _ragged_batch(fixture_tree, int16=kind == "int16")
    quantize = kind == "quantize_output"
    want = jpipeline.make_separate_fn(jmodel, quantize_output=quantize)(
        params, jnp.asarray(batch.mix), jnp.asarray(batch.frame_lengths)
    )
    got = pipeline.make_separate_fn(model, quantize_output=quantize)(
        torch.from_numpy(batch.mix), torch.from_numpy(batch.frame_lengths)
    )
    if quantize:
        (codes, scale), (jcodes, jscale) = got, want
        assert codes.dtype == torch.int16
        np.testing.assert_allclose(scale.numpy(), np.asarray(jscale), rtol=1e-5)
        # one code step is scale/32767; float noise can round across a step
        assert np.abs(codes.numpy().astype(np.int32) - np.asarray(jcodes)).max() <= 1
    else:
        assert tuple(got.shape) == want.shape == (2, 2, want.shape[-1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_frames_past_each_length_are_masked(fixture_tree, models):
    _, _, model = models
    batch = _ragged_batch(fixture_tree, int16=False)
    lens = torch.from_numpy(batch.frame_lengths)
    out = pipeline.make_separate_fn(model)(torch.from_numpy(batch.mix), lens)
    short = int(lens.argmin())
    tail = pipeline.separated_length(int(lens[short]), 256, 128) + 256
    assert out[short, :, tail:].abs().max().item() == 0.0


def test_separate_directory_matches_jax(fixture_tree, models, tmp_path):
    jmodel, params, model = models
    split = fixture_tree / "tt"
    want = jpipeline.separate_directory(jmodel, params, split, tmp_path / "jax", batch_size=2)
    got = pipeline.separate_directory(model, split, tmp_path / "torch", batch_size=2)
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 4
    for g, w in zip(got, want):
        rate_g, pcm_g = wavfile.read(g)
        rate_w, pcm_w = wavfile.read(w)
        assert rate_g == rate_w == 8000 and pcm_g.shape == pcm_w.shape
        assert np.abs(pcm_g.astype(np.int32) - pcm_w).max() <= LSB, g.name


def test_to_host_keeps_cpu_tensors_and_maps_tuples():
    wave = torch.linspace(-1.0, 1.0, 12).reshape(1, 2, 6)
    assert to_host(wave) is wave
    codes, scale = torch.ones(1, 2, 6, dtype=torch.int16), torch.ones(1, 2)
    out = to_host((codes, scale))
    assert type(out) is tuple and len(out) == 2
    assert out[0] is codes and out[1] is scale


@pytest.mark.parametrize("quantize", [False, True], ids=["float", "quantize_output"])
def test_make_separate_fn_returns_its_estimates_on_the_host(fixture_tree, models, monkeypatch,
                                                            quantize):
    _, _, model = models
    batch = _ragged_batch(fixture_tree, int16=False)
    handed = []

    def spy(x):
        handed.append(x)
        return to_host(x)

    monkeypatch.setattr(pipeline, "to_host", spy)
    got = pipeline.make_separate_fn(model, quantize_output=quantize)(
        torch.from_numpy(batch.mix), torch.from_numpy(batch.frame_lengths)
    )
    # one hand-over a call, of what the call computed; on the CPU the very same tensors
    assert len(handed) == 1
    tensors = got if quantize else (got,)
    want = handed[0] if quantize else (handed[0],)
    assert len(tensors) == len(want) == (2 if quantize else 1)
    for g, w in zip(tensors, want):
        assert g is w and g.device.type == "cpu"
    if quantize:
        assert got[0].dtype == torch.int16 and got[1].dtype == torch.float32


@pytest.mark.parametrize("int16", [False, True], ids=["float", "transfer_int16"])
def test_separate_directory_writes_the_estimates_it_returns(fixture_tree, models, tmp_path,
                                                            int16):
    _, _, model = models
    split = fixture_tree / "tt"
    got = pipeline.separate_directory(model, split, tmp_path / "dir", transfer_int16=int16)
    separate = pipeline.make_separate_fn(model, quantize_output=int16)
    want = []
    for batch in WaveformLoader(split, batch_size=2, transfer_int16=int16):
        out = separate(torch.from_numpy(batch.mix), torch.from_numpy(batch.frame_lengths))
        wavs = dequantize_estimates_i16(*(t.numpy() for t in out)) if int16 else out.numpy()
        for i, (name, frames) in enumerate(zip(batch.names, batch.frame_lengths.tolist())):
            n = pipeline.separated_length(int(frames), 256, 128)
            for s in range(2):
                path = tmp_path / "one" / f"{pathlib.Path(name).stem}_s{s + 1}.wav"
                path.parent.mkdir(exist_ok=True)
                audiowrite(wavs[i, s, :n], path, samplerate=8000, normalize=True)
                want.append(path)
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 4
    for g, w in zip(got, want):
        assert g.read_bytes() == w.read_bytes(), g.name


def test_separate_directory_int16_transfer(fixture_tree, models, tmp_path):
    _, _, model = models
    split = fixture_tree / "tt"
    # unnormalised writes keep the estimates' own scale, where the int16
    # transfer adds at most half a code step (0.5 LSB for in-range estimates)
    floats = pipeline.separate_directory(model, split, tmp_path / "f32", normalize=False)
    ints = pipeline.separate_directory(
        model, split, tmp_path / "i16", normalize=False, transfer_int16=True
    )
    assert [f.name for f in floats] == [i.name for i in ints]
    for f, i in zip(floats, ints):
        assert np.abs(wavfile.read(f)[1].astype(np.int32) - wavfile.read(i)[1]).max() <= LSB


def test_loader_pads_to_quanta_and_prefetch_keeps_names(fixture_tree):
    loader = WaveformLoader(fixture_tree / "tr", batch_size=2, pad_quantum_seconds=0.125)
    batches = list(prefetch_to_device(iter(loader), "cpu"))
    assert len(batches) == len(loader) == 1
    batch = batches[0]
    assert isinstance(batch.mix, torch.Tensor) and batch.mix.shape[-1] % 1000 == 0
    assert batch.names == tuple(loader.names)
    i16 = next(iter(WaveformLoader(fixture_tree / "tr", batch_size=2, transfer_int16=True)))
    np.testing.assert_array_equal(i16.mix, quantize_i16(next(iter(loader)).mix))


def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['speech_separation_tpu'] = None\n"
        "import speech_separation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax', 'speech_separation_tpu.'))\n"
        "               for m, v in sys.modules.items() if v is not None)\n"
        "print(' '.join(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 22
    assert {
        "speech_separation_tpu_torch.models.tasnet",
        "speech_separation_tpu_torch.models.tasnet_serving",
        "speech_separation_tpu_torch.ops.tcn_cuda",
        "speech_separation_tpu_torch.ops.tcn_train_cuda",
        "speech_separation_tpu_torch.separate.tasnet_chunked",
    } <= names


def test_build_command_targets_sm90a_with_every_source(tmp_path):
    names = sorted(s.name for s in _build.SOURCES)
    assert names == [
        "lstm_recurrence.cu", "lstm_train_backward.cu", "mask_decode.cu", "nearest_code.cu",
        "residual_layer_norm.cu", "stft_analysis.cu", "tcn_train_backward.cu", "tcn_trunk.cu",
        "wide_attention.cu",
    ]
    assert [s.name for s in _build.HEADERS] == ["tcn_common.cuh"]
    *compiles, link = _build.nvcc_commands("nvcc", tmp_path / "lib.so")
    # one compile per source, run together, then one link of their objects
    assert all("arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd for cmd in compiles)
    sources = [c for cmd in compiles for c in cmd if c.endswith(".cu")]
    assert [pathlib.Path(c).name for c in sources] == names
    assert all(pathlib.Path(c).is_file() for c in sources)
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    assert link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    assert [c for c in link if c.endswith(".o")] == [cmd[-1] for cmd in compiles]


def test_find_nvcc_raises_without_a_toolkit(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension

    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
