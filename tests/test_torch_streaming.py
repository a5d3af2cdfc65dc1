"""PyTorch port, Conv-TasNet streaming on the CPU, against the JAX package: the
window engine (``separate/streaming.py``) on an oracle that swaps its windows
and on a tiny gLN model with carried weights, hop for hop and permutation for
permutation; the exact stateful engine (``separate/streaming_stateful.py``)
against the offline forward of the port and of JAX on the hop-padded
waveform; and ``cli separate --streaming-hop-seconds`` on gLN and causal
checkpoints."""

import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from speech_separation_tpu.data import audiowrite as jax_audiowrite
from speech_separation_tpu.models import ConvTasNet as JaxConvTasNet
from speech_separation_tpu.models.tasnet_serving import pallas_apply
from speech_separation_tpu.separate.streaming import StreamingSeparator as JaxStreamingSeparator
from speech_separation_tpu.separate.streaming import stream_separate as jax_stream_separate
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply
from speech_separation_tpu_torch.separate import (
    CausalStreamingSeparator,
    StreamingSeparator,
    stateful_stream_separate,
    stream_separate,
)
from speech_separation_tpu_torch.utils import UPitTrainConfig, save_config
from speech_separation_tpu_torch.weights import convtasnet_params

# JAX tests/test_streaming_stateful.py's configuration
TINY = dict(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3, blocks=3,
            repeats=2)
# the stateful engine against the offline forward: JAX's bound
RTOL, ATOL = 1e-4, 1e-5
# the window engine on one fp32 model in both packages: float noise of two
# frameworks' convolutions, far below the 1e-4 asked of it
WINDOW_ATOL = 1e-4
LSB = 2  # written int16 wavs: peak-normalised then truncated, so float noise flips an LSB
BF16_PAIR_DB = 30.0  # the --kernel pallas pair of tests/test_torch_tasnet_cli.py
FIXTURE = dict(utterances_per_split=2, min_seconds=0.4, max_seconds=1.1, seed=5)


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


def _perturbed(causal: bool, seed: int = 0) -> ConvTasNet:
    """A tiny ConvTasNet, its norms, biases and slopes moved from init by seeded noise."""
    model = ConvTasNet(**TINY, causal=causal, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            scale = {"gamma": 0.2, "beta": 0.1, "bias": 0.1, "alpha": 0.05}.get(name.rsplit(".", 1)[-1])
            if scale:
                p += torch.from_numpy(scale * rng.standard_normal(p.shape).astype(np.float32))
    return model.eval()


def test_window_stream_realigns_swapped_windows_as_jax():
    """An oracle separator that swaps its channels on odd calls: the port's
    stitched output equals JAX's exactly and recovers both sources."""
    sr = 8000
    t = np.arange(4 * sr) / sr
    s1 = np.sin(2 * np.pi * 220 * t).astype(np.float32) * 0.5
    s2 = np.sign(np.sin(2 * np.pi * 50 * t)).astype(np.float32) * 0.3
    mix = s1 + s2
    hop, window = int(0.5 * sr), int(2.0 * sr)

    def swapping(calls):
        def apply(batch):
            i = calls[0]
            calls[0] += 1
            end = (i + 1) * hop
            seg = np.zeros((2, window), np.float32)
            for k, src in enumerate((s1, s2)):
                piece = src[max(0, end - window) : end]
                seg[k, window - piece.shape[0] :] = piece
            if i % 2 == 1:
                seg = seg[::-1]
            return seg[None].copy()

        return apply

    jax_apply = swapping([0])
    want, _ = jax_stream_separate(lambda m: jnp.asarray(jax_apply(m)), mix, sample_rate=sr,
                                  hop_seconds=0.5, context_seconds=1.5)
    port_apply = swapping([0])
    got, latencies = stream_separate(lambda m: torch.from_numpy(port_apply(m)), mix,
                                     sample_rate=sr, hop_seconds=0.5, context_seconds=1.5)
    assert got.shape == (2, mix.shape[0]) and len(latencies) == 8
    np.testing.assert_array_equal(got, np.asarray(want))
    assert _snr_db(s1, got[0]) > 40.0 and _snr_db(s2, got[1]) > 40.0


def test_window_stream_of_a_gln_model_matches_jax():
    """A tiny gLN ConvTasNet with the same weights in both packages: each hop's
    emission within 1e-4 and the same speaker permutation chosen each hop;
    ``stream_separate`` over the whole waveform too."""
    model = _perturbed(causal=False)
    jmodel = JaxConvTasNet(**TINY)
    params = convtasnet_params(model.state_dict())
    rng = np.random.default_rng(3)
    mix = (rng.standard_normal(9 * 1200) * 0.1).astype(np.float32)
    kw = dict(hop_seconds=0.15, context_seconds=0.3)

    def port_apply(m):
        with torch.no_grad():
            return model(m)

    def jax_apply(m):
        return jmodel.apply({"params": params}, m)

    port, ref = StreamingSeparator(port_apply, **kw), JaxStreamingSeparator(jax_apply, **kw)
    perms = set()
    for i in range(9):
        hop = mix[i * 1200 : (i + 1) * 1200]
        got, want = port.push(hop), ref.push(hop)
        assert port._perm == ref._perm, i
        perms.add(port._perm)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=WINDOW_ATOL)
    got, lat = stream_separate(port_apply, mix[:10000], **kw)
    want, _ = jax_stream_separate(jax_apply, mix[:10000], **kw)
    assert got.shape == (2, 10000) and len(lat) == 9
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=WINDOW_ATOL)


def test_window_stream_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="context_seconds > 0"):
        StreamingSeparator(lambda m: m, context_seconds=0.0)
    with pytest.raises(ValueError, match="hop > 0"):
        StreamingSeparator(lambda m: m, hop_seconds=0.0)
    sep = StreamingSeparator(lambda m: m, num_speakers=1, context_seconds=0.0, hop_seconds=0.01)
    with pytest.raises(ValueError, match="exactly 80 samples"):
        sep.push(np.zeros(79, np.float32))


def _offline(model, mix_padded):
    with torch.no_grad():
        return model(torch.from_numpy(mix_padded)).numpy()


@pytest.mark.parametrize("samples,hop", [(4000, 400), (3300, 512), (2048, 16)])
def test_stateful_stream_matches_offline(samples, hop):
    """The emissions equal the offline forward on the hop-padded waveform, the
    port's and JAX's, at JAX's bound; one latency a push."""
    model = _perturbed(causal=True)
    rng = np.random.default_rng(1)
    mix = (rng.standard_normal((1, samples)) * 0.1).astype(np.float32)
    est, lat = stateful_stream_separate(model, mix[0], hop)
    n_hops = -(-samples // hop)
    padded = np.zeros((1, n_hops * hop), np.float32)
    padded[:, :samples] = mix
    want = _offline(model, padded)[0][:, :samples]
    assert est.shape == want.shape == (2, samples)
    np.testing.assert_allclose(est, want, rtol=RTOL, atol=ATOL)
    jmodel = JaxConvTasNet(**TINY, causal=True)
    jax_want = np.asarray(jmodel.apply({"params": convtasnet_params(model.state_dict())},
                                       jnp.asarray(padded)))[0][:, :samples]
    np.testing.assert_allclose(est, jax_want, rtol=RTOL, atol=ATOL)
    assert len(lat) == n_hops


def test_stateful_stream_batched_and_incremental():
    """Batched pushes with the state carried between them; the flush's tail exact."""
    model = _perturbed(causal=True, seed=2)
    rng = np.random.default_rng(2)
    b, samples, hop = 3, 1600, 160
    mix = (rng.standard_normal((b, samples)) * 0.1).astype(np.float32)
    sep = CausalStreamingSeparator(model, hop)
    outs = [sep.push(mix[:, i * hop : (i + 1) * hop]) for i in range(samples // hop)]
    assert outs[0].shape == (b, 2, hop - 16 + 8 - 4) and outs[1].shape == (b, 2, hop)
    assert sep._state.in_buf.shape == (b, 12)
    outs.append(sep.flush())
    est = np.concatenate(outs, axis=2)[:, :, :samples]
    np.testing.assert_allclose(est, _offline(model, mix), rtol=RTOL, atol=ATOL)
    batched, _ = stateful_stream_separate(model, mix, hop)
    assert batched.shape == (b, 2, samples)
    np.testing.assert_allclose(batched, est, rtol=0, atol=0)


def test_stateful_refusals():
    with pytest.raises(ValueError, match="causal=True"):
        CausalStreamingSeparator(_perturbed(causal=False), 160)
    with pytest.raises(ValueError, match="fp32"):
        CausalStreamingSeparator(_perturbed(causal=True).to(torch.bfloat16), 160)
    for hop in (12, 8, 164):  # not a stride multiple, or below win
        with pytest.raises(ValueError, match="multiple of 8"):
            CausalStreamingSeparator(_perturbed(causal=True), hop)


def test_stateful_lifecycle_guards():
    """flush before a push, a second flush and a push after the flush raise;
    a failed first push leaves the stream unstarted."""
    model = _perturbed(causal=True)
    rng = np.random.default_rng(0)
    sep = CausalStreamingSeparator(model, 160)
    with pytest.raises(RuntimeError, match="before any push"):
        sep.flush()
    with pytest.raises(RuntimeError):
        sep.push(rng.standard_normal((1, 2, 160)).astype(np.float32))  # not [B, hop]
    assert sep._state is None
    sep.push(rng.standard_normal(160).astype(np.float32))
    sep.flush()
    with pytest.raises(RuntimeError, match="twice"):
        sep.flush()
    with pytest.raises(RuntimeError, match="after flush"):
        sep.push(rng.standard_normal(160).astype(np.float32))


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("stream_fixture"), **FIXTURE)


def _checkpoint(directory, causal: bool) -> ConvTasNet:
    model = _perturbed(causal)
    state = train.TrainState.create(model, train.adam(), seed=0)
    train.CheckpointManager(directory).save_if_best(0, state, 0.0)
    save_config(UPitTrainConfig(
        variant="tasnet", batch_size=2, seed=0, tasnet_enc_dim=TINY["enc_dim"],
        tasnet_win=TINY["win"], tasnet_bottleneck=TINY["bottleneck"], tasnet_hidden=TINY["hidden"],
        tasnet_blocks=TINY["blocks"], tasnet_repeats=TINY["repeats"], tasnet_causal=causal,
    ), directory / "train_config.json")
    return model


def _pcm(directory):
    return {p.name: wavfile.read(p)[1] for p in sorted(directory.glob("*.wav"))}


def _write_streams(stream_fn, root, out_dir, write):
    """``stream_fn(mix)``'s ``[S, samples]`` per mixture of ``tt``, written as the CLI does."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for b in WaveformLoader(root / "tt", batch_size=2):
        for i, name in enumerate(b.names):
            est = stream_fn(b.mix[i, : b.sample_lengths[i]])
            for s in range(2):
                write(est[s], out_dir / f"{name[:-4]}_s{s + 1}.wav", 8000, normalize=True)


# the JSON keys of the JAX CLI's streaming line, and the port's "device"
STREAM_KEYS = {"written", "out_dir", "streaming_hop_s", "effective_hop_samples", "effective_hop_s",
               "streaming_engine", "context_seconds", "median_hop_latency_ms", "device"}


@pytest.mark.parametrize("causal,kernel", [(False, "xla"), (False, "pallas"), (True, "xla")],
                         ids=["gln", "gln-kernel", "causal"])
def test_cli_separate_streaming_matches_jax(fixture_tree, tmp_path, capsys, causal, kernel):
    """``cli separate --streaming-hop-seconds 0.5`` against the JAX engines on
    the same weights: a gLN checkpoint through the window engine (with
    ``--kernel pallas`` each window through ``cuda_apply``, held against JAX's
    ``pallas_apply`` and the port's own stream), a causal one through the
    exact stateful engine (the hop 0.5 s = 4,000 samples)."""
    model = _checkpoint(tmp_path / "ckpt", causal)
    cli.main(["separate", "--checkpoint-dir", str(tmp_path / "ckpt"), "--data-root",
              str(fixture_tree), "--out-dir", str(tmp_path / "port"), "--device", "cpu",
              "--streaming-hop-seconds", "0.5", "--streaming-context-seconds", "1.0",
              "--kernel", kernel, "--chunk-seconds", "0.3", "--transfer-int16"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == STREAM_KEYS
    assert report["written"] == 4 and report["device"] == "cpu"
    assert report["streaming_engine"] == ("stateful_exact" if causal else "window")
    assert report["context_seconds"] == (None if causal else 1.0)
    assert report["effective_hop_samples"] == 4000 and report["effective_hop_s"] == 0.5
    got = _pcm(tmp_path / "port")

    jmodel = JaxConvTasNet(**TINY, causal=causal)
    params = convtasnet_params(model.state_dict())
    if causal:
        def jax_stream(mix):
            n_hops = -(-len(mix) // 4000)
            padded = np.zeros((1, n_hops * 4000), np.float32)
            padded[0, : len(mix)] = mix
            return np.asarray(jmodel.apply({"params": params}, jnp.asarray(padded)))[0][:, : len(mix)]
    else:
        def jax_apply(m):
            if kernel == "pallas":
                return pallas_apply(params, m, interpret=True, **TINY)
            return jmodel.apply({"params": params}, m)

        def jax_stream(mix):
            return jax_stream_separate(jax_apply, mix, hop_seconds=0.5, context_seconds=1.0)[0]
    _write_streams(jax_stream, fixture_tree, tmp_path / "jax", jax_audiowrite)
    want = _pcm(tmp_path / "jax")
    assert list(got) == list(want) and len(got) == 4
    for name in got:
        assert len(got[name]) == len(want[name])
        if kernel == "pallas":
            assert _snr_db(want[name], got[name]) >= BF16_PAIR_DB, name
        else:
            assert np.abs(got[name].astype(np.int32) - want[name]).max() <= LSB, name
    if kernel == "pallas":
        from speech_separation_tpu_torch.data.audio_io import audiowrite

        _write_streams(lambda mix: stream_separate(lambda m: cuda_apply(model, m), mix,
                                                   hop_seconds=0.5, context_seconds=1.0)[0],
                       fixture_tree, tmp_path / "own", audiowrite)
        own = _pcm(tmp_path / "own")
        for name in got:
            assert np.abs(got[name].astype(np.int32) - own[name]).max() <= LSB, name


def test_cli_streaming_causal_checkpoint_refuses_the_kernel(fixture_tree, tmp_path):
    """The stateful engine runs no trunk kernel, so --kernel pallas on a causal
    checkpoint stays refused when streaming."""
    _checkpoint(tmp_path / "ckpt", causal=True)
    with pytest.raises(SystemExit, match="gLN topology") as info:
        cli.main(["separate", "--checkpoint-dir", str(tmp_path / "ckpt"), "--data-root",
                  str(fixture_tree), "--out-dir", str(tmp_path / "sep"), "--device", "cpu",
                  "--streaming-hop-seconds", "0.5", "--kernel", "pallas"])
    assert info.value.code not in (0, None)
    assert not list((tmp_path / "sep").glob("*.wav"))
