"""PyTorch port, Conv-TasNet serving through the CLI on the CPU, against the JAX
pipeline on the same padded batches: ``cli separate`` with ``--kernel xla``
(the module's forward) and ``--kernel pallas`` (``cuda_apply``, whose trunk
runs its plain version on a CPU tensor), the chunked path, and the refusals."""

import json
import pathlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from speech_separation_tpu.data import audiowrite as jax_audiowrite
from speech_separation_tpu.models import ConvTasNet as JaxConvTasNet
from speech_separation_tpu.models.tasnet_serving import pallas_apply
from speech_separation_tpu.separate.tasnet_chunked import separate_chunked as jax_separate_chunked
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.audio_io import audiowrite
from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply
from speech_separation_tpu_torch.separate.tasnet_chunked import separate_chunked
from speech_separation_tpu_torch.utils import UPitTrainConfig, save_config
from speech_separation_tpu_torch.weights import convtasnet_params

TOY = dict(num_speakers=2, enc_dim=64, win=16, bottleneck=32, hidden=48, kernel=3, blocks=4, repeats=2)
FIXTURE = dict(utterances_per_split=2, min_seconds=0.4, max_seconds=1.1, seed=5)
LSB = 2  # written int16 wavs: peak-normalised then truncated, so float noise flips an LSB
# --kernel pallas is bf16 on both sides, with roundings at different places
# (the encoder's bias, the folded products), which differ by ~40 dB from
# each other as each does from fp32 (tests/test_torch_tasnet.py); its wavs
# are held to the JAX pipeline at 30 dB, and to the port's own cuda_apply
# on the same batch within the LSB bound.
BF16_PAIR_DB = 30.0


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("tasnet_fixture"), **FIXTURE)


def _checkpoint(directory: pathlib.Path, causal: bool = False) -> ConvTasNet:
    """A toy-width tasnet checkpoint written by the port, its norms, biases and
    slopes perturbed from init by seeded noise; returns the model."""
    model = ConvTasNet(**TOY, causal=causal, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            scale = {"gamma": 0.2, "beta": 0.1, "bias": 0.1, "alpha": 0.05}.get(leaf)
            if scale:
                p += torch.from_numpy(scale * rng.standard_normal(p.shape).astype(np.float32))
    state = train.TrainState.create(model, train.adam(), seed=0)
    train.CheckpointManager(directory).save_if_best(0, state, 0.0)
    cfg = UPitTrainConfig(
        variant="tasnet", batch_size=2, seed=0, tasnet_enc_dim=TOY["enc_dim"],
        tasnet_win=TOY["win"], tasnet_bottleneck=TOY["bottleneck"], tasnet_hidden=TOY["hidden"],
        tasnet_blocks=TOY["blocks"], tasnet_repeats=TOY["repeats"], tasnet_causal=causal,
    )
    save_config(cfg, directory / "train_config.json")
    return model.eval()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    directory = tmp_path_factory.mktemp("tasnet_ckpt")
    return directory, _checkpoint(directory)


def _separate(checkpoint_dir, root, out_dir, *extra):
    cli.main(["separate", "--checkpoint-dir", str(checkpoint_dir), "--data-root", str(root),
              "--out-dir", str(out_dir), "--device", "cpu", *extra])


def _write_all(est_fn, root, out_dir, write, batch_size=2):
    """Write ``est_fn(padded batch)``'s estimates per mixture, trimmed to true length."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for b in WaveformLoader(root / "tt", batch_size=batch_size):
        est = np.asarray(est_fn(b.mix))
        for i, name in enumerate(b.names):
            for s in range(2):
                write(est[i, s, : b.sample_lengths[i]], out_dir / f"{name[:-4]}_s{s + 1}.wav", 8000,
                      normalize=True)


def _pcm(directory):
    return {p.name: wavfile.read(p)[1] for p in sorted(directory.glob("*.wav"))}


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_cli_separate_matches_jax(fixture_tree, checkpoint, tmp_path, capsys, kernel):
    ckpt, model = checkpoint
    _separate(ckpt, fixture_tree, tmp_path / "port", "--kernel", kernel)
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = _pcm(tmp_path / "port")
    assert report["written"] == len(got) == 4
    for name, pcm in got.items():  # each of its mixture's true length
        assert len(pcm) == len(wavfile.read(fixture_tree / "tt" / "mix" / (name[:-7] + ".wav"))[1])

    jmodel = JaxConvTasNet(**TOY)
    params = convtasnet_params(model.state_dict())
    if kernel == "xla":
        def jax_fn(mix):
            return jmodel.apply({"params": params}, jnp.asarray(mix))
    else:
        def jax_fn(mix):
            return pallas_apply(params, jnp.asarray(mix), interpret=True, **TOY)
    _write_all(jax_fn, fixture_tree, tmp_path / "jax", jax_audiowrite)
    want = _pcm(tmp_path / "jax")
    assert list(want) == list(got)
    for name in got:
        if kernel == "xla":
            assert np.abs(got[name].astype(np.int32) - want[name]).max() <= LSB, name
        else:
            assert _snr_db(want[name], got[name]) >= BF16_PAIR_DB, name
    if kernel == "pallas":
        _write_all(lambda m: cuda_apply(model, torch.from_numpy(m)).numpy(), fixture_tree,
                   tmp_path / "own", audiowrite)
        own = _pcm(tmp_path / "own")
        for name in got:
            assert np.abs(got[name].astype(np.int32) - own[name]).max() <= LSB, name


def test_cli_separate_chunked_matches_jax(fixture_tree, checkpoint, tmp_path):
    ckpt, model = checkpoint
    _separate(ckpt, fixture_tree, tmp_path / "port", "--chunk-seconds", "0.5",
              "--chunk-overlap-seconds", "0.125")
    got = _pcm(tmp_path / "port")
    jmodel = JaxConvTasNet(**TOY)
    params = convtasnet_params(model.state_dict())
    loader = WaveformLoader(fixture_tree / "tt", batch_size=2)
    (tmp_path / "jax").mkdir()
    for b in loader:
        for i, name in enumerate(b.names):
            est = jax_separate_chunked(
                lambda m: jmodel.apply({"params": params}, m), b.mix[i, : b.sample_lengths[i]],
                chunk_seconds=0.5, overlap_seconds=0.125,
            )
            for s in range(2):
                jax_audiowrite(est[s], tmp_path / "jax" / f"{name[:-4]}_s{s + 1}.wav", 8000,
                               normalize=True)
    want = _pcm(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        assert np.abs(got[name].astype(np.int32) - want[name]).max() <= LSB, name


def test_separate_chunked_matches_jax_with_one_apply_fn():
    """The stitching alone: a deterministic separator whose speaker order
    flips with the chunk's content, so the permutation alignment must act."""
    rng = np.random.default_rng(7)
    mix = rng.standard_normal(5300).astype(np.float32)

    def fake(x, lib):
        a, b = 0.5 * x, lib.tanh(2.0 * x) - 0.2 * x
        flip = lib.mean(x, axis=-1, keepdims=True) > 0
        return lib.stack([lib.where(flip, b, a), lib.where(flip, a, b)], axis=1)

    want = jax_separate_chunked(lambda m: fake(m, jnp), mix, chunk_seconds=0.25,
                                overlap_seconds=0.05)
    got = separate_chunked(lambda m: torch.from_numpy(fake(m.numpy(), np)), mix,
                           chunk_seconds=0.25, overlap_seconds=0.05)
    assert got.shape == want.shape == (2, 5300)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="overlap"):
        separate_chunked(lambda m: m, mix, chunk_seconds=0.25, overlap_seconds=0.25)


def test_cli_batch_size_matches_jax(fixture_tree, checkpoint, tmp_path):
    """--batch-size 1 pads each mixture to its own quantum (gLN statistics see
    the padding), and the JAX module on the same batches agrees."""
    ckpt, model = checkpoint
    _separate(ckpt, fixture_tree, tmp_path / "port", "--batch-size", "1")
    jmodel = JaxConvTasNet(**TOY)
    params = convtasnet_params(model.state_dict())
    _write_all(lambda m: jmodel.apply({"params": params}, jnp.asarray(m)), fixture_tree,
               tmp_path / "jax", jax_audiowrite, batch_size=1)
    got, want = _pcm(tmp_path / "port"), _pcm(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        assert np.abs(got[name].astype(np.int32) - want[name]).max() <= LSB, name


def test_cli_int16_transfer_matches_jax(fixture_tree, checkpoint, tmp_path):
    """int16 PCM up, int16 estimates down, against the JAX wire format on the
    same batches. A code that rounds the other way at .5 moves a sample by
    max(peak, 1) / 32767, which peak normalisation magnifies by 1 / peak: a
    bound in dB, not in LSBs."""
    from speech_separation_tpu.ops.quant import quantize_estimates_i16 as jax_quantize

    ckpt, model = checkpoint
    _separate(ckpt, fixture_tree, tmp_path / "port", "--transfer-int16")
    jmodel = JaxConvTasNet(**TOY)
    params = convtasnet_params(model.state_dict())

    def jax_fn(mix):
        codes, scale = jax_quantize(jmodel.apply({"params": params}, jnp.asarray(mix)))
        return np.asarray(codes, np.float32) * (np.asarray(scale)[..., None] / 32767.0)

    _write_all(jax_fn, fixture_tree, tmp_path / "jax", jax_audiowrite)
    got, want = _pcm(tmp_path / "port"), _pcm(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        assert _snr_db(want[name], got[name]) >= 60.0, name


def test_cli_causal_checkpoint_refuses_the_pallas_kernel(fixture_tree, tmp_path):
    model = _checkpoint(tmp_path / "ckpt", causal=True)
    with pytest.raises(SystemExit, match="gLN topology") as info:
        _separate(tmp_path / "ckpt", fixture_tree, tmp_path / "sep", "--kernel", "pallas")
    assert info.value.code not in (0, None)
    assert not list((tmp_path / "sep").glob("*.wav"))
    # the module's own forward serves it, and matches the JAX causal module
    _separate(tmp_path / "ckpt", fixture_tree, tmp_path / "sep", "--kernel", "xla")
    jmodel = JaxConvTasNet(**TOY, causal=True)
    params = convtasnet_params(model.state_dict())
    _write_all(lambda m: jmodel.apply({"params": params}, jnp.asarray(m)), fixture_tree,
               tmp_path / "jax", jax_audiowrite)
    got, want = _pcm(tmp_path / "sep"), _pcm(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        assert np.abs(got[name].astype(np.int32) - want[name]).max() <= LSB, name


def test_cli_train_refuses_tasnet(fixture_tree, tmp_path):
    """Conv-TasNet trains since its training slice; what stays refused is a
    causal (cLN) model through the gLN-only kernel trunk."""
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"variant": "tasnet", "tasnet_causal": True,
                               "tasnet_pallas_trunk": True}))
    with pytest.raises(SystemExit, match="gLN") as info:
        cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "1",
                  "--checkpoint-dir", str(tmp_path / "ckpt"), "--device", "cpu"])
    assert info.value.code not in (0, None)
    assert not (tmp_path / "ckpt").exists()
