"""PyTorch port, DPRNN-TasNet (``models/dprnn.py``) on the CPU: segmentation
and overlap-add, the module against the benchmark's plain reference
(``bench_torch/reference/dprnn.py``) forward and through the SI-SDR PIT
loss's gradients, which recurrence path serving and training take, the
parameter count at the published widths, ``cli train --variant dprnn`` and
``cli separate`` on a fixture, and the shared models' outputs bit for bit
before and after a DPRNN runs in the same process."""

from __future__ import annotations

import contextlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from bench_torch.reference import dprnn as reference
from speech_separation_tpu_torch import cli
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.losses import pit_si_sdr_loss
from speech_separation_tpu_torch.models import blstm, dprnn
from speech_separation_tpu_torch.models.dprnn import DPRNN, overlap_add, segment, serving_fn
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.utils import UPitTrainConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = dict(num_speakers=2, enc_dim=8, win=2, bottleneck=8, hidden=16, chunk=10, blocks=2)
FORWARD_ATOL = 1e-5  # fp32 on both sides, sums in other orders
GRAD_REL = 1e-4  # relative L2 of each parameter's gradient against the reference's autograd
BF16_DB = 20.0  # bf16 serving against fp32: 8-bit mantissas through 2 x 2 recurrences of 30 steps


def _toy(seed: int = 7) -> tuple[DPRNN, dict]:
    """The toy model with the reference's seeded weights."""
    weights = reference.make_weights(TOY, seed, "cpu")
    model = DPRNN(**TOY)
    model.load_state_dict(weights)
    return model.eval(), weights


@contextlib.contextmanager
def _one_thread():
    """One CPU thread for torch inside the block: the plain loops' small ops
    run ~50× slower when the test workers' thread pools oversubscribe the
    cores, and the bit-for-bit comparisons need one summation order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _mix(shape, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("frames,hop", [(23, 5), (25, 5), (1, 5), (80, 20), (7, 1)])
def test_segment_then_overlap_add_gives_each_frame_twice(frames, hop):
    x = _mix((2, frames, 3))
    chunks = segment(x, hop)
    assert chunks.shape == (2, dprnn.chunks_of(frames, hop), 2 * hop, 3)
    assert dprnn.chunks_of(frames, hop) == -(-frames // hop) + 1
    torch.testing.assert_close(overlap_add(chunks, frames), 2 * x, rtol=0, atol=0)
    # the first chunk starts hop frames before frame 0, each chunk hop after the last
    n = min(hop, frames)
    assert torch.equal(chunks[:, 0, hop:hop + n], x[:, :n])
    assert torch.count_nonzero(chunks[:, 0, :hop]) == 0
    if frames > hop:
        assert torch.equal(chunks[:, 1, :hop], chunks[:, 0, hop:])


def test_forward_matches_the_reference():
    model, weights = _toy()
    mix = _mix((3, 123), seed=1)
    with torch.no_grad():
        got = model(mix)
    want = reference.separate(weights, TOY, mix)
    assert got.shape == want.shape == (3, 2, 123) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= FORWARD_ATOL


def test_pit_si_sdr_gradients_match_the_reference_autograd():
    model, weights = _toy(seed=8)
    mix = _mix((2, 97), seed=2)
    sources = _mix((2, 2, 97), seed=3)
    lengths = torch.tensor([97, 80])
    pit_si_sdr_loss(model(mix), sources, lengths).backward()
    params = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    loss = pit_si_sdr_loss(reference.forward(params, TOY, mix), sources, lengths)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    for name, p in model.named_parameters():
        want = grads[name]
        assert ((p.grad - want).norm() / want.norm().clamp_min(1e-30)).item() <= GRAD_REL, name


def test_serving_runs_the_recurrence_and_training_the_training_kernels(monkeypatch):
    calls = {"serve": 0, "train": 0}
    serve, trained = blstm.lstm_recurrence, blstm.bilstm_train

    def counting_serve(*args, **kwargs):
        calls["serve"] += 1
        return serve(*args, **kwargs)

    def counting_train(*args, **kwargs):
        calls["train"] += 1
        return trained(*args, **kwargs)

    monkeypatch.setattr(blstm, "lstm_recurrence", counting_serve)
    monkeypatch.setattr(blstm, "bilstm_train", counting_train)
    model, _ = _toy()
    mix = _mix((2, 40))
    serving_fn(model)(mix)
    assert calls == {"serve": 2 * TOY["blocks"], "train": 0}
    model(mix).sum().backward()
    assert calls == {"serve": 2 * TOY["blocks"], "train": 2 * TOY["blocks"]}


def test_bf16_serving_stays_near_fp32():
    model, _ = _toy()
    mix = _mix((2, 150), seed=4)
    want = serving_fn(model)(mix)
    got = serving_fn(model, bf16=True)(mix)
    assert got.dtype == torch.float32 and next(model.parameters()).dtype == torch.float32
    snr = 10 * math.log10(want.square().sum().item() / (got - want).square().sum().item())
    assert snr >= BF16_DB


def test_parameter_count_at_the_published_widths_equals_the_config():
    cfg = json.loads((ROOT / "bench_torch" / "configs" / "dprnn.json").read_text())
    model = DPRNN()  # the defaults are the paper's row
    count = sum(p.numel() for p in model.parameters())
    assert count == cfg["parameters"] == 2_583_426
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == reference.param_shapes(cfg)


def test_unequal_overlap_and_odd_widths_are_refused():
    for chunk in (251, 0):
        with pytest.raises(ValueError, match="chunk must be even"):
            DPRNN(chunk=chunk)
    assert DPRNN(**TOY).hop == TOY["chunk"] // 2
    with pytest.raises(ValueError, match="multiple of win//2"):
        DPRNN(**{**TOY, "win": 4})(torch.zeros(1, 9))
    UPitTrainConfig(variant="dprnn")
    with pytest.raises(ValueError, match="variant='conv'"):
        UPitTrainConfig(variant="conv")


CLI_TOY = {"variant": "dprnn", "batch_size": 2, "dprnn_enc_dim": 8, "dprnn_bottleneck": 8,
           "dprnn_hidden": 8, "dprnn_chunk": 40, "dprnn_blocks": 2}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train --variant dprnn`` for two epochs on a two-utterance fixture
    of 0.1-0.2 s: 800 to 1,600 frames at stride 1, 41 to 81 chunks of 40."""
    tmp = tmp_path_factory.mktemp("dprnn_cli")
    root = make_synthetic_fixture(tmp / "fx", utterances_per_split=2, min_seconds=0.1,
                                  max_seconds=0.2, seed=5)
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps({k: v for k, v in CLI_TOY.items() if k != "variant"}))
    with _one_thread():
        cli.main(["train", "--config", str(cfg), "--variant", "dprnn", "--data-root", str(root),
                  "--epochs", "2", "--checkpoint-dir", str(tmp / "ckpt"), "--device", "cpu"])
    return root, tmp / "ckpt"


def test_cli_train_writes_a_dprnn_checkpoint(trained, capsys):
    _, ckpt = trained
    saved = json.loads((ckpt / "train_config.json").read_text())
    assert saved["variant"] == "dprnn" and saved["dprnn_chunk"] == 40
    lines = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in lines if "epoch" in r]
    assert len(epochs) == 2 and all(math.isfinite(r["val_loss"]) for r in epochs)


@pytest.mark.parametrize("extra", [[], ["--bf16"], ["--chunk-seconds", "0.05",
                                                    "--chunk-overlap-seconds", "0.0125"]],
                         ids=["whole", "bf16", "chunked"])
def test_cli_separate_serves_the_checkpoint(trained, tmp_path, capsys, extra):
    root, ckpt = trained
    with _one_thread():
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root), "--out-dir",
                  str(tmp_path / "sep"), "--device", "cpu", *extra])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wavs = sorted((tmp_path / "sep").glob("*.wav"))
    assert report["written"] == len(wavs) == 4
    for p in wavs:  # each of its mixture's true length, not silent
        pcm = wavfile.read(p)[1]
        assert len(pcm) == len(wavfile.read(root / "tt" / "mix" / (p.name[:-7] + ".wav"))[1])
        assert np.abs(pcm).max() > 0


@pytest.mark.parametrize("extra,match", [(["--streaming-hop-seconds", "0.5"], "streaming"),
                                         (["--kernel", "pallas"], "kernel pallas")])
def test_cli_separate_refuses_what_dprnn_does_not_serve(trained, tmp_path, extra, match):
    root, ckpt = trained
    with pytest.raises(SystemExit, match=match):
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root),
                  "--out-dir", str(tmp_path / "sep"), "--device", "cpu", *extra])
    assert not (tmp_path / "sep").exists()


SHARED = ("upit.forward", "upit.train", "upit.grad", "tasnet.forward", "tasnet.grad")


def _shared_outputs() -> dict:
    """The uPIT BLSTM's and Conv-TasNet's outputs and gradients on fixed
    inputs, one CPU thread."""
    with _one_thread():
        rng = np.random.default_rng(11)
        upit = UPitBlstm(hidden=16, num_layers=2, generator=torch.Generator().manual_seed(3))
        mag = torch.from_numpy(np.abs(rng.standard_normal((2, 30, 129))).astype(np.float32))
        tasnet = ConvTasNet(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3,
                            blocks=3, repeats=2, generator=torch.Generator().manual_seed(4))
        mix = torch.from_numpy(rng.standard_normal((2, 1600)).astype(np.float32))
        with torch.no_grad():
            outs = {"upit.forward": upit(mag), "tasnet.forward": tasnet(mix)}
        trained_out = upit(mag)  # under autograd: the training recurrences
        trained_out.square().sum().backward()
        outs["upit.train"] = trained_out.detach()
        outs["upit.grad"] = torch.cat([p.grad.flatten() for p in upit.parameters()])
        tasnet(mix).square().sum().backward()
        outs["tasnet.grad"] = torch.cat([p.grad.flatten() for p in tasnet.parameters()
                                         if p.grad is not None])
    return outs


@pytest.fixture(scope="module")
def shared_outputs():
    """The shared models' outputs before and after a DPRNN is built, served,
    trained a step and checked against its reference in the same process."""
    before = _shared_outputs()
    model, weights = _toy(seed=9)
    mix = _mix((2, 60), seed=6)
    serving_fn(model)(mix)
    serving_fn(model, bf16=True)(mix)
    model(mix).square().sum().backward()
    reference.separate(weights, TOY, mix)
    return before, _shared_outputs()


@pytest.mark.parametrize("name", SHARED)
def test_shared_models_unchanged_bit_for_bit(shared_outputs, name):
    """DPRNN reuses the BiLSTM, the encoder, the decoder and gLN: running it
    leaves no state behind that moves the other models' outputs by a bit."""
    before, after = shared_outputs
    assert torch.equal(before[name], after[name])
