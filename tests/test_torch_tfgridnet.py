"""PyTorch port, TF-GridNet (``models/tfgridnet.py``), the wide-head attention
(``ops/wide_attention_cuda.py``) and the square-root Hann STFT on the CPU at
toy widths: the module against the benchmark's plain reference
(``bench_torch/reference/tfgridnet.py``) in fp32 and in bf16 serving, the
attention's plain version against the written-out product, the parameter
count at the published widths, the spans, ``cli train --variant tfgridnet``
and ``cli separate`` with their refusals, the default (Blackman) STFT and
iSTFT unchanged, the square-root Hann round trip, and the uPIT BLSTM's,
DPRNN's and SepFormer's outputs unchanged by a TF-GridNet served beside
them. One CPU thread."""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np
import pytest
import torch
from scipy.io import wavfile
from torch.profiler import ProfilerActivity, profile

from bench_torch.reference import dprnn as dprnn_reference
from bench_torch.reference import sepformer as sepformer_reference
from bench_torch.reference import tfgridnet as reference
from speech_separation_tpu import ops as jops
from speech_separation_tpu_torch import cli, ops
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models import dprnn, sepformer
from speech_separation_tpu_torch.models.tfgridnet import TFGridNet, products_in_bf16, serving_fn
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.ops import stft as tstft
from speech_separation_tpu_torch.ops import windows
from speech_separation_tpu_torch.ops.stft_cuda import fft_table, stft_cuda, stft_fft_plain
from speech_separation_tpu_torch.ops.wide_attention_cuda import (
    wide_attention,
    wide_attention_plain,
    wide_attention_scores,
    wide_attention_scores_plain,
)
from speech_separation_tpu_torch.utils import UPitTrainConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
# F = 9 bins (odd), E = ceil(16 / 9) = 2: Q and K rows of 18 values, V rows of 36
TOY = dict(num_speakers=2, n_fft=16, hop=4, d_model=8, blocks=2, kernel=3, hidden=6, heads=2,
           qk_dim=16, eps=1e-5)
FORWARD_REL = 1e-5  # fp32 on both sides, sums in other orders (the toy reads ~4e-7)
# bf16 serving against fp32: 8-bit mantissas in every product of two blocks'
# recurrences, transposed convs, 1x1s and attention, the stream fp32 (the toy
# reads 46.0-46.8 dB over its three seeds)
BF16_DB = 30.0


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for torch: the toy's small ops run far slower when the
    test workers' thread pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(seed: int = 7, **widths) -> tuple[TFGridNet, dict, dict]:
    """The toy model with the reference's seeded weights, and its widths."""
    cfg = {**TOY, **widths}
    weights = reference.make_weights(cfg, seed, "cpu")
    model = TFGridNet(**cfg)
    model.load_state_dict(weights)
    return model.eval(), weights, cfg


def _mix(shape, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _snr_db(got: torch.Tensor, want: torch.Tensor) -> float:
    return 10 * math.log10(want.square().sum().item() / (got - want).square().sum().item())


@pytest.mark.parametrize("samples", [203, 96])  # 53 and 27 frames of 9 bins
def test_forward_matches_the_reference(samples):
    model, weights, cfg = _toy()
    mix = _mix((3, samples), seed=1)
    with torch.no_grad():
        got = model(mix)
    want = reference.separate(weights, cfg, mix)
    assert got.shape == want.shape == (3, 2, samples) and got.dtype == torch.float32
    assert _rel(got, want) <= FORWARD_REL


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_bf16_serving_against_the_fp32_reference(seed):
    model, weights, cfg = _toy(seed=seed)
    mix = _mix((2, 160), seed=seed)
    want = reference.separate(weights, cfg, mix)
    got = serving_fn(model, bf16=True)(mix)
    assert got.dtype == torch.float32 and next(model.parameters()).dtype == torch.float32
    assert _snr_db(got, want) >= BF16_DB
    # the products' weights in bf16; the encoder conv, decoder, norms and slopes fp32
    dtypes = {k: v.dtype for k, v in products_in_bf16(model).state_dict().items()}
    bf16 = {k for k, v in dtypes.items() if v == torch.bfloat16}
    assert bf16 == {k for k in dtypes
                    if "_rnn." in k or "_linear." in k or (".attn_" in k and ".conv." in k)}
    assert dtypes["conv.kernel"] == dtypes["deconv.kernel"] == torch.float32
    assert dtypes["block_0.attn_v.gamma"] == dtypes["block_1.attn_q.alpha"] == torch.float32


def test_the_fp8_control_is_far_from_the_reference():
    model, weights, cfg = _toy(seed=4)
    mix = _mix((2, 160), seed=4)
    want = reference.separate(weights, cfg, mix)
    served = _rel(serving_fn(model, bf16=True)(mix), want)
    control = _rel(reference.separate(weights, cfg, mix, precision="fp8"), want)
    assert control >= 3 * served


def test_wide_attention_plain_is_the_written_out_product():
    q, k = (_mix((3, 11, 18), seed=s).double() for s in (5, 6))
    v = _mix((3, 11, 36), seed=7).double()
    scores = torch.einsum("nld,nmd->nlm", q, k) / math.sqrt(18)
    probs = torch.exp(scores) / torch.exp(scores).sum(-1, keepdim=True)
    want = torch.einsum("nlm,nmd->nld", probs, v)
    for dtype, rel in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        got = wide_attention_plain(q.to(dtype), k.to(dtype), v.to(dtype))
        assert got.dtype == dtype and _rel(got.double(), want) <= rel
        p = wide_attention_scores_plain(q.to(dtype), k.to(dtype))
        assert p.dtype == torch.float32 and _rel(p.double(), probs) <= rel
    # the reference's own attention over one head: the same scores, softmax and product
    ref = reference._mm(torch.softmax(reference._mm(q.float(), k.float().transpose(1, 2), "fp32")
                                      / math.sqrt(18), dim=-1), v.float(), "fp32")
    assert _rel(wide_attention_plain(q.float(), k.float(), v.float()).double(), ref.double()) <= 1e-6
    # a CPU tensor, or the scoped switch, takes the plain version
    args = (q.float(), k.float(), v.float())
    assert torch.equal(wide_attention(*args), wide_attention_plain(*args))
    with ops.plain_versions():
        assert torch.equal(wide_attention(*args), wide_attention_plain(*args))
        assert torch.equal(wide_attention_scores(*args[:2]), wide_attention_scores_plain(*args[:2]))


def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("case", ["fp32", "shapes", "rank", "devices", "autograd", "v", "v_fp32",
                                  "meta"])
def test_wide_attention_refuses_what_the_kernel_does_not_take(case):
    """A meta tensor stands for a device with a kernel: the wrapper checks
    dtype, shapes and autograd first, then refuses any tensor that is not on
    one CUDA device (a meta one too) rather than fall back."""
    q, k, v = _meta(4, 7, 18), _meta(4, 7, 18), _meta(4, 7, 36)
    error, match = ValueError, "one CUDA device"
    if case == "fp32":
        q, error, match = q.float(), TypeError, "takes bf16"
    elif case == "shapes":
        k, match = _meta(4, 7, 19), "of one shape"
    elif case == "rank":
        q, k, match = _meta(4, 7, 2, 9), _meta(4, 7, 2, 9), "of one shape"
    elif case == "devices":
        k = torch.zeros(4, 7, 18, dtype=torch.bfloat16)
    elif case == "autograd":
        q, error, match = _meta(4, 7, 18, grad=True), RuntimeError, "no backward"
    elif case == "v":
        v, match = _meta(4, 6, 36), "v \\[N, L, dv\\] beside q"
    elif case == "v_fp32":
        v, error, match = _meta(4, 7, 36, dtype=torch.float32), TypeError, "takes bf16 v"
    with pytest.raises(error, match=match):
        wide_attention(q, k, v)
    with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):
        wide_attention_scores(_meta(4, 7, 18, grad=True), _meta(4, 7, 18))


def test_parameter_count_at_the_published_widths_equals_the_config():
    cfg = json.loads((ROOT / "bench_torch" / "configs" / "tfgridnet.json").read_text())
    with torch.device("meta"):
        model = TFGridNet()  # the defaults are the published widths
    count = sum(p.numel() for p in model.parameters())
    # ESPnet's module list is 15,169,080 with two LSTM biases a gate; one here
    assert count == 15_169_080 - 4 * 2 * 2 * 1024 == cfg["parameters"] == 15_152_696
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == reference.param_shapes(cfg)
    widths = ("n_fft", "hop", "d_model", "blocks", "kernel", "hidden", "heads", "qk_dim")
    assert tuple(cfg[k] for k in widths) == (256, 64, 128, 4, 4, 256, 4, 512)
    assert model.freqs == 129 and model.qk_width == 4 and cfg["reduced"] == []


def test_widths_the_model_cannot_take_are_refused():
    with pytest.raises(ValueError, match="do not divide d_model"):
        TFGridNet(**{**TOY, "heads": 3})
    with pytest.raises(ValueError, match="unfold kernel"):
        TFGridNet(**{**TOY, "kernel": 10})
    with pytest.raises(ValueError, match="fewer than the unfold kernel"), torch.no_grad():
        TFGridNet(**{**TOY, "kernel": 5})(_mix((1, 2)))  # 4 frames
    with pytest.raises(ValueError, match="no deviation"), torch.no_grad():
        TFGridNet(**TOY)(_mix((1, 1)))
    UPitTrainConfig(variant="tfgridnet")


def _spans(prof, name: str) -> list[tuple[int, int]]:
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name)


def test_spans_once_a_block_a_forward():
    model, _, _ = _toy()
    mix = _mix((2, 96), seed=9)
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        traced = [model(mix) for _ in range(2)]
    parts = [_spans(prof, f"sst.tfgridnet.{p}") for p in ("intra", "inter", "attention")]
    assert [len(s) for s in parts] == [2 * TOY["blocks"]] * 3
    for intra, inter, attention in zip(*parts):  # intra, inter, attention, a block
        assert intra[1] <= inter[0] and inter[1] <= attention[0]
    assert len(_spans(prof, "sst.tfgridnet.encode")) == len(_spans(prof, "sst.tfgridnet.decode")) == 2
    with torch.no_grad():
        assert all(torch.equal(t, model(mix)) for t in traced)


def test_default_window_keeps_the_blackman_stft_bit_for_bit():
    """The uPIT path's STFT and iSTFT: the default window is the JAX
    package's Blackman, and its dual keeps the reference's skipped index."""
    for size, shift in ((256, 128), (256, 64), (512, 128)):
        for ours, theirs in ((windows.analysis_window(size), jops.analysis_window(size)),
                             (windows.biorthogonal_synthesis_window(size, shift),
                              jops.biorthogonal_synthesis_window(size, shift))):
            assert np.array_equal(ours, np.asarray(theirs))
        assert torch.equal(tstft.analysis_basis(size), tstft.analysis_basis(size, None, "blackman"))
        assert torch.equal(tstft.synthesis_basis(size, shift),
                           tstft.synthesis_basis(size, shift, None, "blackman"))
        assert torch.equal(fft_table(size), fft_table(size, None, "blackman"))
    x = _mix((2, 1000), seed=3)
    spec = tstft.stft(x, 256, 128)
    assert torch.equal(spec, tstft.stft(x, 256, 128, window="blackman"))
    assert torch.equal(stft_cuda(x, 256, 128), spec)
    assert torch.equal(stft_fft_plain(x, 256, 128), stft_fft_plain(x, 256, 128, window="blackman"))
    assert torch.equal(tstft.istft(spec, 256, 128), tstft.istft(spec, 256, 128, window="blackman"))


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_sqrt_hann_round_trip_reconstructs_the_signal(method):
    win = windows.analysis_window(256, window="sqrt_hann")
    np.testing.assert_allclose(win, np.sqrt(np.hanning(257)[:256]), rtol=0, atol=1e-15)
    # at hop 64 the periodic Hann sums to 2 at every sample: the dual is w / 2
    np.testing.assert_allclose(windows.biorthogonal_synthesis_window(256, 64, window="sqrt_hann"),
                               win / 2, rtol=1e-14, atol=0)
    x = _mix((3, 1234), seed=4)
    spec = tstft.stft(x, 256, 64, method=method, window="sqrt_hann")
    back = tstft.istft(spec, 256, 64, method=method, window="sqrt_hann")[:, :1234]
    assert _rel(back, x) <= 1e-6
    # the kernel's algorithm reads the same window from its table
    assert _rel(stft_fft_plain(x, 256, 64, window="sqrt_hann"), spec) <= 1e-6
    with pytest.raises(ValueError, match="unknown window"):
        windows.analysis_window(256, window="hann")


CLI_TOY = {"batch_size": 2, "tfgridnet_n_fft": 16, "tfgridnet_hop": 4, "tfgridnet_d_model": 8,
           "tfgridnet_blocks": 1, "tfgridnet_kernel": 3, "tfgridnet_hidden": 6,
           "tfgridnet_heads": 2, "tfgridnet_qk_dim": 16}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cli train --variant tfgridnet`` for two epochs on a two-utterance
    fixture of 0.1-0.2 s: 202 to 402 frames of 9 bins."""
    tmp = tmp_path_factory.mktemp("tfgridnet_cli")
    root = make_synthetic_fixture(tmp / "fx", utterances_per_split=2, min_seconds=0.1,
                                  max_seconds=0.2, seed=5)
    cfg = tmp / "cfg.json"
    cfg.write_text(json.dumps(CLI_TOY))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main(["train", "--config", str(cfg), "--variant", "tfgridnet", "--data-root", str(root),
                  "--epochs", "2", "--checkpoint-dir", str(tmp / "ckpt"), "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return root, tmp / "ckpt", cfg


def test_cli_train_writes_a_tfgridnet_checkpoint(trained):
    _, ckpt, _ = trained
    saved = json.loads((ckpt / "train_config.json").read_text())
    assert saved["variant"] == "tfgridnet" and saved["tfgridnet_n_fft"] == 16
    lines = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in lines if "epoch" in r]
    assert len(epochs) == 2 and all(math.isfinite(r["val_loss"]) for r in epochs)


@pytest.mark.parametrize("extra", [[], ["--bf16"]], ids=["whole", "bf16"])
def test_cli_separate_serves_the_checkpoint(trained, tmp_path, capsys, extra):
    root, ckpt, _ = trained
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
def test_cli_separate_refuses_what_tfgridnet_does_not_serve(trained, tmp_path, extra, match):
    root, ckpt, _ = trained
    with pytest.raises(SystemExit, match=match):
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root),
                  "--out-dir", str(tmp_path / "sep"), "--device", "cpu", *extra])
    assert not (tmp_path / "sep").exists()


def test_cli_refuses_the_gpu_without_bf16_or_for_training(trained, tmp_path, monkeypatch):
    """On a GPU (``_device`` answers cuda here; nothing reaches a card):
    ``separate`` without ``--bf16`` and ``train`` at all exit with the reason."""
    root, ckpt, cfg = trained
    monkeypatch.setattr(cli, "_device", lambda name: torch.device("cuda"))
    restore = cli._restore_upit
    monkeypatch.setattr(cli, "_restore_upit", lambda path, device: restore(path, torch.device("cpu")))
    with pytest.raises(SystemExit, match="wide_attention kernel, which takes bf16"):
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root),
                  "--out-dir", str(tmp_path / "sep")])
    with pytest.raises(SystemExit, match="no backward"):
        cli.main(["train", "--config", str(cfg), "--variant", "tfgridnet", "--data-root",
                  str(root), "--epochs", "1", "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert not (tmp_path / "sep").exists() and not (tmp_path / "ckpt").exists()


def _others(mix: torch.Tensor) -> dict[str, torch.Tensor]:
    """The uPIT BLSTM's, DPRNN's and SepFormer's served outputs on seeded weights."""
    from speech_separation_tpu_torch.separate.pipeline import make_separate_fn

    upit = UPitBlstm(hidden=8, num_layers=1, num_speakers=2, generator=torch.Generator().manual_seed(1))
    upit_fn = make_separate_fn(upit, 256, 128, 2)
    dcfg = dict(num_speakers=2, enc_dim=8, win=2, bottleneck=8, hidden=16, chunk=10, blocks=1)
    dmodel = dprnn.DPRNN(**dcfg)
    dmodel.load_state_dict(dprnn_reference.make_weights(dcfg, 3, "cpu"))
    scfg = dict(num_speakers=2, enc_dim=16, win=16, d_model=32, heads=4, ffn=64, layers=1, chunk=8,
                blocks=1)
    smodel = sepformer.SepFormer(**scfg)
    smodel.load_state_dict(sepformer_reference.make_weights(scfg, 3, "cpu"))
    frames = tstft.stft_frame_count(mix.shape[1], 256, 128)
    return {"upit": upit_fn(mix, torch.full((mix.shape[0],), frames)),
            "dprnn": dprnn.serving_fn(dmodel)(mix),
            "sepformer": sepformer.serving_fn(smodel, bf16=True)(mix)}


def test_other_separators_unchanged_beside_a_served_tfgridnet():
    mix = _mix((2, 640), seed=11)
    before = _others(mix)
    model, _, _ = _toy()
    serving_fn(model, bf16=True)(mix)
    serving_fn(model)(mix)
    after = _others(mix)
    for name in before:
        assert torch.equal(before[name], after[name]), name
