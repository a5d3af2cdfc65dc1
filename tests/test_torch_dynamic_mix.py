"""PyTorch port, dynamic mixing and the synthetic corpora on the CPU, against
the JAX package: ``WaveformLoader(dynamic_mix=True)`` batch for batch over
several epochs (bit-identical), its two overflow scenarios, the
``make_synthetic_librimix`` trees sample for sample, the speaker metadata,
and ``cli train`` with ``dynamic_mix`` on a LibriMix-shaped corpus."""

import json
import pathlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from speech_separation_tpu.data.datasets import WaveformLoader as JaxWaveformLoader
from speech_separation_tpu.data.fixture import make_synthetic_librimix as jax_make_librimix
from speech_separation_tpu.data.speaker_info import load_speaker_genders as jax_genders
from speech_separation_tpu.data.speaker_info import mixture_genders as jax_mixture_genders
from speech_separation_tpu_torch import cli
from speech_separation_tpu_torch.data import (
    WaveformLoader,
    load_speaker_genders,
    make_synthetic_fixture,
    make_synthetic_librimix,
    mixture_genders,
)
from speech_separation_tpu_torch.data.audio_io import audiowrite
from speech_separation_tpu_torch.ops.quant import dequant_i16

EPOCHS = 3


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A 2- and a 3-speaker split of 10 utterances each, lengths 0.3 to 0.9 s."""
    root = tmp_path_factory.mktemp("dm")
    return {
        s: make_synthetic_fixture(root / f"s{s}", utterances_per_split={"tr": 10, "cv": 1, "tt": 1},
                                  min_seconds=0.3, max_seconds=0.9, seed=s, num_speakers=s,
                                  profile="hard")
        for s in (2, 3)
    }


def _assert_same_batches(port, ref):
    assert len(port) == len(ref) > 0
    for got, want in zip(port, ref):
        assert got.names == want.names
        for field in ("mix", "sources", "sample_lengths", "frame_lengths"):
            a, b = getattr(got, field), np.asarray(getattr(want, field))
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("int16", [False, True], ids=["float", "int16"])
@pytest.mark.parametrize("speakers", [2, 3])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "fixed-order"])
def test_dynamic_mix_batches_match_jax(corpora, int16, speakers, shuffle):
    """Three epochs of the port's loader against the JAX loader on one split:
    the pairings, gains, crops and remix bit for bit, each epoch fresh."""
    kw = dict(batch_size=3, num_speakers=speakers, shuffle=shuffle, seed=4, sort_by_length=True,
              dynamic_mix=True, dynamic_window_batches=2, transfer_int16=int16,
              pad_quantum_seconds=0.25)
    port = WaveformLoader(corpora[speakers] / "tr", **kw)
    ref = JaxWaveformLoader(corpora[speakers] / "tr", **kw)
    epochs = []
    for _ in range(EPOCHS):
        got = list(port)
        _assert_same_batches(got, list(ref))
        for b in got:
            want = b.sources.astype(np.int32).sum(axis=1) if int16 else b.sources.sum(axis=1)
            np.testing.assert_array_equal(b.mix, want)  # mix == Σ sources, exactly
            for i, n in enumerate(b.sample_lengths):
                assert not b.sources[i, :, n:].any()
        epochs.append(np.concatenate([b.sources.reshape(-1) for b in got]))
    assert port._epoch == ref._epoch == EPOCHS
    assert not np.array_equal(epochs[0], epochs[1]), "the epochs must remix"
    port.set_epoch(1)
    again = list(port)
    np.testing.assert_array_equal(np.concatenate([b.sources.reshape(-1) for b in again]), epochs[1])


def test_fixed_loader_is_unchanged_beside_dynamic_mixing(corpora):
    """Without ``dynamic_mix`` the loader reads the stored mixtures, as before,
    and a given ``names`` list is kept (the JAX init field)."""
    root = corpora[2] / "tr"
    kw = dict(batch_size=4, shuffle=True, seed=1, sort_by_length=True)
    port, ref = WaveformLoader(root, **kw), JaxWaveformLoader(root, **kw)
    _assert_same_batches(list(port), list(ref))
    names = sorted(p.name for p in (root / "mix").glob("*.wav"))[:3]
    assert WaveformLoader(root, names=list(names)).names == names


def _loud_split(tmp_path, amplitude):
    """Two utterances of near-full-scale square-ish sources (JAX tests/test_data.py)."""
    sr, n = 8000, 4000
    root = tmp_path / "tr"
    for d in ("mix", "s1", "s2"):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ("a.wav", "b.wav"):
        s1 = np.sign(rng.standard_normal(n)).astype(np.float32) * amplitude
        s2 = np.sign(rng.standard_normal(n)).astype(np.float32) * amplitude
        audiowrite(s1, root / "s1" / name, sr)
        audiowrite(s2, root / "s2" / name, sr)
        audiowrite(np.clip(s1 + s2, -1, 1), root / "mix" / name, sr)
    return root


def test_dynamic_mix_int16_mix_survives_overflow(tmp_path):
    """Gained sources whose quantized sum passes int16: the int32 mix lane is
    their exact sum, the dequantized mix the dequantized sources' sum, and
    every batch equals JAX's."""
    root = _loud_split(tmp_path, 0.98)
    kw = dict(batch_size=2, shuffle=True, dynamic_mix=True, transfer_int16=True, seed=3)
    port = list(WaveformLoader(root, **kw))
    _assert_same_batches(port, list(JaxWaveformLoader(root, **kw)))
    saw_overflow = False
    for b in port:
        assert b.mix.dtype == np.int32 and b.sources.dtype == np.int16
        i32sum = b.sources.astype(np.int32).sum(axis=1)
        np.testing.assert_array_equal(b.mix, i32sum)
        saw_overflow |= bool(np.abs(i32sum).max() > 32767)
        mix_dev = dequant_i16(torch.from_numpy(b.mix)).numpy()
        src_dev = dequant_i16(torch.from_numpy(b.sources)).numpy().sum(axis=1)
        np.testing.assert_allclose(mix_dev, src_dev, atol=1e-6)
    assert saw_overflow


def test_dynamic_mix_int16_gained_sources_never_clip(tmp_path):
    """A positive gain on a full-scale source would clip on the int16 path;
    the row is attenuated on both paths, so the int16 targets stay the float
    targets, and both equal JAX's."""
    root = _loud_split(tmp_path, 0.995)
    kw = dict(batch_size=2, shuffle=True, dynamic_mix=True, seed=5)
    li = list(WaveformLoader(root, transfer_int16=True, **kw))
    lf = list(WaveformLoader(root, transfer_int16=False, **kw))
    _assert_same_batches(li, list(JaxWaveformLoader(root, transfer_int16=True, **kw)))
    _assert_same_batches(lf, list(JaxWaveformLoader(root, transfer_int16=False, **kw)))
    saw_would_clip = False
    for bi, bf in zip(li, lf):
        assert bi.sources.dtype == np.int16
        np.testing.assert_allclose(bi.sources.astype(np.float32) / 32768.0, bf.sources,
                                   atol=1.01 / 65536.0)
        saw_would_clip |= bool(np.abs(bf.sources).max() > 0.99)
    assert saw_would_clip


def _tree(root: pathlib.Path) -> dict[str, np.ndarray]:
    return {str(p.relative_to(root)): wavfile.read(p)[1] for p in sorted(root.rglob("*.wav"))}


@pytest.mark.parametrize("profile,speakers", [("easy", 2), ("hard", 2), ("easy", 3), ("hard", 3)])
def test_make_synthetic_librimix_matches_jax(tmp_path, profile, speakers):
    """The same tree, file names and int16 samples as the JAX generator, both
    bands and both conditions (the easy 2-speaker corpus seeds per utterance,
    the others per (seed, split, utterance))."""
    kw = dict(utterances={"dev": 2, "train-100": 3}, min_seconds=0.5, max_seconds=1.0, seed=7,
              num_speakers=speakers, profile=profile)
    got = _tree(make_synthetic_librimix(tmp_path / "port", **kw))
    want = _tree(jax_make_librimix(tmp_path / "jax", **kw))
    assert list(got) == list(want)
    assert len(got) == 2 * 2 * 5 * (1 + speakers)
    for name in got:
        assert got[name].dtype == np.int16
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    # mix_clean holds the min condition's truncated sum: the loaders find it
    split = tmp_path / "port" / "wav8k" / "min" / "dev"
    loader = WaveformLoader(split, batch_size=2, num_speakers=speakers)
    assert len(loader.names) == 2 and next(iter(loader)).sources.shape[1] == speakers


def test_speaker_genders_match_jax(tmp_path):
    path = tmp_path / "spkrinfo.txt"
    path.write_text("40a M\n40b f\n\n441 F extra\nbad\n447 m\n")
    got, want = load_speaker_genders(path), jax_genders(path)
    assert got == want == {"40a": 1, "40b": 0, "441": 0, "447": 1}
    for name in ("447o0302_0.62948_441c0212_-0.62948.wav", "40ac0101_1.2_40bc0202_-1.2"):
        assert mixture_genders(name, got) == jax_mixture_genders(name, want)
    for fn in (mixture_genders, jax_mixture_genders):
        with pytest.raises(ValueError, match="not a wsj0-2mix mixture name"):
            fn("single_name.wav", got)


@pytest.fixture(scope="module")
def librimix(tmp_path_factory):
    root = tmp_path_factory.mktemp("librimix")
    make_synthetic_librimix(root, utterances={"dev": 2, "train-100": 6}, bands=("wav8k",),
                            conditions=("min",), min_seconds=0.4, max_seconds=0.9, seed=2,
                            profile="hard")
    return root / "wav8k" / "min"


@pytest.mark.parametrize("variant", ["tasnet", "blstm"])
def test_cli_train_dynamic_mix_on_librimix(librimix, tmp_path, capsys, variant):
    """``cli train`` with ``dynamic_mix`` on a LibriMix-shaped corpus: the
    training stream is the dynamically mixed loader's (the JAX CLI's settings),
    and the run trains and validates with finite losses."""
    cfg = {"dynamic_mix": True, "train_split": "train-100", "val_split": "dev", "seed": 0,
           "batch_size": 2, "transfer_int16": True}
    if variant == "tasnet":
        cfg.update(variant="tasnet", tasnet_enc_dim=32, tasnet_bottleneck=16, tasnet_hidden=32,
                   tasnet_blocks=3, tasnet_repeats=2, tasnet_pallas_trunk=True)
    else:
        cfg.update(hidden=8, num_layers=1)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    ckpt = tmp_path / "ckpt"
    seen = []
    original = WaveformLoader._dynamic_batch

    def recording(self, *args):
        batch = original(self, *args)
        seen.append(batch)
        return batch

    WaveformLoader._dynamic_batch = recording
    try:
        cli.main(["train", "--config", str(path), "--data-root", str(librimix), "--epochs", "2",
                  "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    finally:
        WaveformLoader._dynamic_batch = original
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu" and np.isfinite(report["best_val_loss"])
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) == 6 and np.isfinite(losses).all()
    # 2 epochs x 3 batches of the training split, each remixed, none of the dev split
    assert len(seen) == 6
    for b in seen:
        assert set(b.names) <= {p.name for p in (librimix / "train-100" / "mix_clean").iterdir()}
        np.testing.assert_array_equal(b.mix, b.sources.astype(np.int32).sum(axis=1))
    want = JaxWaveformLoader(librimix / "train-100", batch_size=2, shuffle=True, seed=0,
                             transfer_int16=True, dynamic_mix=True, sort_by_length=True)
    _assert_same_batches(seen, [*want, *want])
