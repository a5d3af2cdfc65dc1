"""PyTorch port, the codec through the CLI on the CPU (``--device cpu``):
``train --workload vqvae`` for t3tok and gumbel at toy widths, then
``codec-encode``, ``codec-decode`` and ``codec-roundtrip`` against the JAX
CLI's on the same weights (the port's trained parameters in an orbax
checkpoint), and the refusals."""

import contextlib
import io
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from speech_separation_tpu import cli as jax_cli
from speech_separation_tpu import train as jtrain
from speech_separation_tpu.cli import _build_vae_model as jax_build_vae_model
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.utils import VaeTrainConfig, save_config
from speech_separation_tpu_torch.weights import vqvae_params

FIXTURE = dict(utterances_per_split=2, min_seconds=0.4, max_seconds=1.0, seed=5)
CONFIGS = {
    "t3tok": dict(variant="t3tok", embedding_dim=16, num_embeddings=32, skip_embeddings=32,
                  skip_pq=4, seed=3),
    "gumbel": dict(variant="gumbel", latent_dim=16, seed=3),
}
LSB = 2  # written int16 wavs: peak-normalised then truncated, so float noise flips an LSB


def _run(main, argv) -> dict:
    """Run a CLI ``main`` and return its last JSON line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("codec_fixture"), **FIXTURE)


@pytest.fixture(scope="module")
def trained(fixture_tree, tmp_path_factory):
    """Each variant trained by the port's CLI for 2 epochs: ``{variant:
    (port checkpoint dir, JAX checkpoint dir of the same weights, report)}``."""
    out = {}
    for variant, cfg in CONFIGS.items():
        base = tmp_path_factory.mktemp(f"codec_{variant}")
        (base / "cfg.json").write_text(json.dumps(cfg))
        ckpt = base / "port"
        report = _run(cli.main, ["train", "--workload", "vqvae", "--config", str(base / "cfg.json"),
                                 "--data-root", str(fixture_tree), "--epochs", "2",
                                 "--checkpoint-dir", str(ckpt), "--device", "cpu"])
        # the same weights as an orbax checkpoint the JAX CLI restores
        jcfg = VaeTrainConfig(**cfg)
        state = train.TrainState.create(cli._build_vae_model(jcfg, torch.device("cpu")),
                                        train.adam(), seed=0)
        train.CheckpointManager(ckpt).restore_params(state)
        params = jax.tree.map(jax.numpy.asarray, vqvae_params(state.model.state_dict()))
        jmodel = jax_build_vae_model(variant, jcfg)
        jstate = jtrain.TrainState.create(jmodel.apply, params, jtrain.adam(1e-3), jax.random.key(0))
        jckpt = base / "jax"
        manager = jtrain.CheckpointManager(jckpt)
        manager.save_if_best(1, jstate, 0.0)
        manager.close()
        shutil.copy(ckpt / "train_config.json", jckpt / "train_config.json")
        out[variant] = (ckpt, jckpt, report)
    return out


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_cli_train_vqvae_writes_a_codec_checkpoint(trained, variant):
    ckpt, _, report = trained[variant]
    assert report["best_epoch"] in (1, 2) and np.isfinite(report["best_val_loss"])
    assert report["device"] == "cpu"
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if "epoch" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    saved = json.loads((ckpt / "train_config.json").read_text())
    assert {k: saved[k] for k in CONFIGS[variant]} == CONFIGS[variant]
    assert list(ckpt.glob("ckpt_*.pt"))


def _wav(fixture_tree):
    return sorted((fixture_tree / "tt" / "s1").glob("*.wav"))[0]


def _pcm(path):
    return wavfile.read(path)[1].astype(np.int32)


@pytest.mark.parametrize("variant", list(CONFIGS))
def test_codec_encode_matches_the_jax_cli(trained, fixture_tree, tmp_path, variant):
    ckpt, jckpt, _ = trained[variant]
    suffix = ".npz" if variant == "t3tok" else ".npy"
    args = ["codec-encode", "--wav", str(_wav(fixture_tree))]
    got = _run(cli.main, [*args, "--checkpoint-dir", str(ckpt), "--out", str(tmp_path / f"p{suffix}"),
                          "--device", "cpu"])
    want = _run(jax_cli.main, [*args, "--checkpoint-dir", str(jckpt),
                               "--out", str(tmp_path / f"j{suffix}")])
    assert got.pop("device") == "cpu"
    assert got.pop("codes") != want.pop("codes")
    assert got == want  # shapes, samples and the codebooks' perplexity and usage
    if variant == "t3tok":
        with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
            assert sorted(p.files) == sorted(j.files) == ["deep", "skip"]
            for k in p.files:
                assert p[k].dtype == j[k].dtype == np.int32
                np.testing.assert_array_equal(p[k], j[k])
    else:
        p, j = np.load(tmp_path / "p.npy"), np.load(tmp_path / "j.npy")
        assert p.dtype == j.dtype == np.int32
        np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("variant", list(CONFIGS))
@pytest.mark.parametrize("command", ["codec-decode", "codec-roundtrip"])
def test_codec_reconstruction_matches_the_jax_cli(trained, fixture_tree, tmp_path, variant, command):
    ckpt, jckpt, _ = trained[variant]
    if command == "codec-decode":  # both decode the same codes, written by the JAX CLI
        codes = tmp_path / ("codes.npz" if variant == "t3tok" else "codes.npy")
        _run(jax_cli.main, ["codec-encode", "--checkpoint-dir", str(jckpt),
                            "--wav", str(_wav(fixture_tree)), "--out", str(codes)])
        args = [command, "--codes", str(codes)]
    else:
        args = [command, "--wav", str(_wav(fixture_tree))]
    got = _run(cli.main, [*args, "--checkpoint-dir", str(ckpt), "--out", str(tmp_path / "p.wav"),
                          "--device", "cpu"])
    want = _run(jax_cli.main, [*args, "--checkpoint-dir", str(jckpt), "--out", str(tmp_path / "j.wav")])
    assert got["samples"] == want["samples"]
    p, j = _pcm(tmp_path / "p.wav"), _pcm(tmp_path / "j.wav")
    assert p.shape == j.shape == (got["samples"],)
    assert np.abs(p - j).max() <= LSB


@pytest.fixture(scope="module")
def untrained(tmp_path_factory):
    """v2 and t3 checkpoints at toy width, written by the port without training."""
    out = {}
    for variant in ("v2", "t3"):
        directory = tmp_path_factory.mktemp(f"codec_{variant}")
        cfg = VaeTrainConfig(variant=variant, embedding_dim=8, num_embeddings=16, seed=0)
        state = train.TrainState.create(cli._build_vae_model(cfg, torch.device("cpu")),
                                        train.adam(), seed=0)
        train.CheckpointManager(directory).save_if_best(1, state, 0.0)
        save_config(cfg, directory / "train_config.json")
        out[variant] = directory
    return out


@pytest.mark.parametrize(
    "variant,argv",
    [
        ("v2", ["codec-encode", "--wav", "{wav}", "--out", "{tmp}/codes.npy"]),
        ("t3", ["codec-decode", "--codes", "{tmp}/codes.npy", "--out", "{tmp}/out.wav"]),
    ],
)
def test_codec_refusals_exit_non_zero(untrained, fixture_tree, tmp_path, variant, argv):
    np.save(tmp_path / "codes.npy", np.zeros((1, 4), np.int32))
    argv = [a.format(wav=_wav(fixture_tree), tmp=tmp_path) for a in argv]
    with pytest.raises(SystemExit) as exc:
        cli.main([*argv, "--checkpoint-dir", str(untrained[variant]), "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out.wav").exists()
    # t3 still round-trips: its codes need the raw U-skip
    if variant == "t3":
        report = _run(cli.main, ["codec-roundtrip", "--wav", str(_wav(fixture_tree)), "--out",
                                 str(tmp_path / "rt.wav"), "--checkpoint-dir",
                                 str(untrained[variant]), "--device", "cpu"])
        assert _pcm(tmp_path / "rt.wav").shape == (report["samples"],)


def test_codec_checkpoint_refusals(fixture_tree, tmp_path):
    with pytest.raises(SystemExit, match="no codec checkpoint"):
        cli.main(["codec-roundtrip", "--checkpoint-dir", str(tmp_path / "missing"), "--wav",
                  str(_wav(fixture_tree)), "--out", str(tmp_path / "o.wav"), "--device", "cpu"])
    (tmp_path / "upit").mkdir()
    (tmp_path / "upit" / "train_config.json").write_text(json.dumps({"hidden": 8}))
    with pytest.raises(SystemExit, match="not a codec checkpoint"):
        cli.main(["codec-encode", "--checkpoint-dir", str(tmp_path / "upit"), "--wav",
                  str(_wav(fixture_tree)), "--out", str(tmp_path / "c.npy"), "--device", "cpu"])


@pytest.mark.parametrize("command", ["train", "codec-encode", "codec-decode", "codec-roundtrip"])
def test_the_default_device_exits_without_a_gpu(trained, fixture_tree, tmp_path, command):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: --device cuda is served")
    ckpt = trained["t3tok"][0]
    argv = {
        "train": ["train", "--workload", "vqvae", "--variant", "t3", "--data-root",
                  str(fixture_tree), "--epochs", "1", "--checkpoint-dir", str(tmp_path / "c")],
        "codec-encode": [command, "--checkpoint-dir", str(ckpt), "--wav", str(_wav(fixture_tree)),
                         "--out", str(tmp_path / "c.npz")],
        "codec-decode": [command, "--checkpoint-dir", str(ckpt), "--codes",
                         str(tmp_path / "c.npz"), "--out", str(tmp_path / "o.wav")],
        "codec-roundtrip": [command, "--checkpoint-dir", str(ckpt), "--wav",
                            str(_wav(fixture_tree)), "--out", str(tmp_path / "o.wav")],
    }[command]
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        cli.main(argv)
    assert not (tmp_path / "o.wav").exists() and not (tmp_path / "c.npz").exists()
