"""PyTorch port, uPIT BLSTM training against the JAX reference on the CPU.

Inputs come from numpy seeds and go through both packages; JAX's Pallas
training kernels run in interpret mode, the port's wrappers take their
kernels' plain versions (the tensors lie on the CPU).
"""

import importlib
import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu import train as jtrain
from speech_separation_tpu.data.datasets import WaveformLoader as JaxWaveformLoader
from speech_separation_tpu.losses.pit import pit_loss as jax_pit_loss
from speech_separation_tpu.models import UPitBlstm as JaxUPitBlstm
from speech_separation_tpu.models.blstm import BiLSTM as JaxBiLSTM
from speech_separation_tpu.models.blstm import segment_keep as jax_segment_keep
from speech_separation_tpu.ops.lstm_train_pallas import (
    bilstm_train_pallas,
    bilstm_train_pallas_packed,
)
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.audio_io import read_wav
from speech_separation_tpu_torch.data.datasets import WaveformLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.losses.pit import pit_loss
from speech_separation_tpu_torch.models.blstm import segment_keep
from speech_separation_tpu_torch.models.upit import UPitBlstm, dropout
from speech_separation_tpu_torch.ops.features import psm_features
from speech_separation_tpu_torch.ops.lstm_train_cuda import bilstm_reference, bilstm_train
from speech_separation_tpu_torch.ops.stft import stft_frame_count
from speech_separation_tpu_torch.utils import UPitTrainConfig, load_config
from speech_separation_tpu_torch.weights import upit_blstm_params, upit_blstm_state_dict

jax_features = importlib.import_module("speech_separation_tpu.ops.features")
jax_config = importlib.import_module("speech_separation_tpu.utils.config")

PSM_ATOL = 1e-4  # fp32 STFT, the JAX package's DSP bound
PIT_RTOL = 1e-6  # fp32 sums of the same squared errors in another order
# bilstm_train in fp32 against JAX's fp32 kernels and jax.grad of lax.scan:
# the bounds of tests/test_lstm_train_pallas.py (output 120 dB, gradients 110)
Y_SNR_DB = 120.0
GRAD_SNR_DB = 110.0
OPTIM_RTOL = 1e-6  # fp32 Adam, schedules in float64 here and float32 in optax
STEP_RTOL = 1e-5  # three fp32 train steps: STFT, network, PIT loss, Adam
BILSTM = dict(b=3, t=37, f=12, h=20, tile_t=8)
SMALL = dict(hidden=8, num_layers=2)
FIXTURE = dict(utterances_per_split={"tr": 5, "cv": 2, "tt": 2}, min_seconds=0.4, max_seconds=1.0)


class _Batch(NamedTuple):
    x: np.ndarray


def _snr_db(ref, est):
    ref = np.asarray(ref, np.float64)
    est = np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("train_fixture"), **FIXTURE)


def _waves(batch=2, samples=4000, speakers=2, seed=0):
    sources = _normal((batch, speakers, samples), seed, 0.1)
    sources[1, :, samples * 3 // 4 :] = 0.0  # a shorter second utterance
    lengths = np.asarray(
        [stft_frame_count(samples, 256, 128), stft_frame_count(samples * 3 // 4, 256, 128)],
        np.int32,
    )[:batch]
    return sources.sum(axis=1), sources, lengths


def test_psm_features_match_jax():
    mix, sources, _ = _waves(speakers=3, seed=1)
    want = jax_features.psm_features(jnp.asarray(mix), jnp.asarray(sources))
    got = psm_features(torch.from_numpy(mix), torch.from_numpy(sources))
    for name in ("magnitude", "cos_angle", "sin_angle", "labels"):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=PSM_ATOL, err_msg=name)
    assert got.labels.shape[-1] == 3 * 129


@pytest.mark.parametrize("reduction", ["sum", "mean", "none"])
@pytest.mark.parametrize("speakers", [2, 3])
def test_pit_loss_matches_jax(speakers, reduction):
    b, t, f = 4, 23, 9
    preds = _normal((b, t, speakers * f), 2)
    labels = _normal((b, t, speakers * f), 3)
    lengths = np.asarray([23, 17, 5, 20], np.int32)
    want = jax_pit_loss(jnp.asarray(preds), jnp.asarray(labels), jnp.asarray(lengths), speakers, reduction)
    got = pit_loss(torch.from_numpy(preds), torch.from_numpy(labels), torch.from_numpy(lengths), speakers, reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIT_RTOL)


def test_pit_loss_rejects_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        pit_loss(torch.zeros(1, 2, 4), torch.zeros(1, 2, 4), torch.ones(1), 2, "max")


def test_segment_keep_is_exact():
    seg = np.sort(np.random.default_rng(4).integers(0, 4, (3, 19)), axis=1).astype(np.int32)
    want = np.asarray(jax_segment_keep(jnp.asarray(seg)))
    got = segment_keep(torch.from_numpy(seg))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _bilstm_case(packed: bool):
    b, t, f, h = BILSTM["b"], BILSTM["t"], BILSTM["f"], BILSTM["h"]
    x = jax.random.normal(jax.random.key(0), (b, t, f), jnp.float32) * 0.5
    model = JaxBiLSTM(h)
    params = model.init(jax.random.key(1), x)["params"]["cells"]
    w = jnp.asarray(_normal((b, t, 2 * h), 2))
    seg = np.sort(np.random.default_rng(3).integers(0, 3, (b, t)), axis=1).astype(np.int32)
    return x, model, params, w, (jnp.asarray(seg) if packed else None)


@pytest.mark.parametrize("packed", [False, True])
def test_bilstm_train_matches_jax_kernels_and_scan(packed):
    x, model, cells, w, seg = _bilstm_case(packed)
    tile = BILSTM["tile_t"]
    keep = None
    if packed:
        keep = jnp.stack([jax_segment_keep(seg), jax_segment_keep(seg[:, ::-1])])

    def pallas(x, k, u, bz):
        if packed:
            return bilstm_train_pallas_packed(x, k, u, bz, keep, tile, True, jnp.float32)
        return bilstm_train_pallas(x, k, u, bz, tile, True, jnp.float32)

    def scan(x, k, u, bz):
        p = {"params": {"cells": {"kernel": k, "recurrent_kernel": u, "bias": bz}}}
        return model.apply(p, x, seg)

    args = (x, cells["kernel"], cells["recurrent_kernel"], cells["bias"])
    refs = {}
    for name, fn in (("pallas", pallas), ("scan", scan)):
        y = fn(*args)
        grads = jax.grad(lambda *a: jnp.sum(fn(*a).astype(jnp.float32) * w), argnums=(0, 1, 2, 3))(*args)
        refs[name] = (np.asarray(y), [np.asarray(g) for g in grads])

    tensors = [torch.tensor(np.asarray(a)).requires_grad_() for a in args]
    port_keep = None
    if packed:
        seg_t = torch.tensor(np.asarray(seg))
        port_keep = torch.stack([segment_keep(seg_t), segment_keep(seg_t.flip(1))])
    y = bilstm_train(*tensors, keep=port_keep, compute_dtype=torch.float32)
    (y * torch.tensor(np.asarray(w))).sum().backward()
    for name, (ref_y, ref_grads) in refs.items():
        assert _snr_db(ref_y, y.detach().numpy()) > Y_SNR_DB, name
        for arg, ref_g, t in zip(("dx", "dkernel", "drecurrent", "dbias"), ref_grads, tensors):
            assert _snr_db(ref_g, t.grad.numpy()) > GRAD_SNR_DB, (name, arg)


@pytest.mark.parametrize("packed", [False, True])
def test_bilstm_train_grads_match_autograd_reference(packed):
    x, _, cells, w, seg = _bilstm_case(packed)
    keep = None
    if packed:
        seg_t = torch.tensor(np.asarray(seg))
        keep = torch.stack([segment_keep(seg_t), segment_keep(seg_t.flip(1))])
    args = [np.asarray(a) for a in (x, cells["kernel"], cells["recurrent_kernel"], cells["bias"])]
    outs = []
    for run in (
        lambda *a: bilstm_train(*a, keep=keep, compute_dtype=torch.float32),
        lambda *a: bilstm_reference(*a, keep=keep),
    ):
        tensors = [torch.tensor(a).requires_grad_() for a in args]
        y = run(*tensors)
        (y * torch.tensor(np.asarray(w))).sum().backward()
        outs.append((y.detach().numpy(), [t.grad.numpy() for t in tensors]))
    (y_a, g_a), (y_b, g_b) = outs
    assert _snr_db(y_b, y_a) > Y_SNR_DB
    for a, b in zip(g_a, g_b):
        assert _snr_db(b, a) > GRAD_SNR_DB


def test_bilstm_train_bf16_stores_bf16_and_grads_are_param_dtype():
    x, _, cells, w, _ = _bilstm_case(False)
    tensors = [
        torch.tensor(np.asarray(a)).requires_grad_()
        for a in (x, cells["kernel"], cells["recurrent_kernel"], cells["bias"])
    ]
    y = bilstm_train(*tensors, compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    want = bilstm_reference(*[t.detach() for t in tensors])
    # bf16 operands and stored gates (8-bit mantissa), fp32 carries
    assert (y.float() - want).abs().max().item() < 5e-2
    (y.float() * torch.tensor(np.asarray(w))).sum().backward()
    assert all(t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all() for t in tensors)


def _optim_pair(kind):
    if kind == "exponential_decay_clipped":
        return (
            jtrain.exponential_decay_adam(1e-3, 20, 0.96, grad_clip_norm=1.0),
            train.exponential_decay_adam(1e-3, 20, 0.96, grad_clip_norm=1.0),
        )
    if kind == "cosine_warmup":
        return (
            jtrain.cosine_adam(1e-3, total_steps=20, warmup_steps=5, grad_clip_norm=2.0),
            train.cosine_adam(1e-3, total_steps=20, warmup_steps=5, grad_clip_norm=2.0),
        )
    return jtrain.adam(1e-3), train.adam(1e-3)


@pytest.mark.parametrize("kind", ["exponential_decay_clipped", "cosine_warmup", "adam"])
def test_optimizer_matches_optax(kind):
    shapes = {"w": (7, 5), "b": (5,), "u": (3, 4, 2)}
    params = {k: _normal(s, i) for i, (k, s) in enumerate(shapes.items())}
    tx, make = _optim_pair(kind)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make(tparams.values())
    clipped = 0
    for step in range(25):  # spans the staircase edge at step 20
        scale = 0.05 if step != 7 else 5.0  # step 7's global norm is far above the clip
        grads = {k: _normal(s, 100 + step * 3 + i, scale) for i, (k, s) in enumerate(shapes.items())}
        clipped += np.sqrt(sum(np.square(g).sum() for g in grads.values())) > 1.0
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]), rtol=OPTIM_RTOL,
                err_msg=f"{kind} step {step} {k}",
            )
    assert clipped == 1
    assert opt.param_groups[0]["count"] == 25


def test_exponential_decay_schedule_is_read_before_the_update():
    schedule = train.exponential_decay_adam().keywords["schedule"]
    assert schedule(0) == 1e-3 and schedule(19) == 1e-3
    assert schedule(20) == pytest.approx(0.96e-3, rel=1e-12)


def _jax_and_port_states(dropout_rate=0.0):
    jmodel = JaxUPitBlstm(**SMALL, dropout_rate=dropout_rate)
    rng = jax.random.key(0)
    params = jmodel.init(rng, jnp.zeros((1, 4, 129)))["params"]
    jstate = jtrain.TrainState.create(jmodel.apply, params, jtrain.exponential_decay_adam(), rng)
    model = UPitBlstm(**SMALL, dropout_rate=dropout_rate)
    model.load_state_dict(upit_blstm_state_dict(jax.tree.map(np.asarray, params)))
    state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
    return jmodel, jstate, model, state


def test_train_and_eval_steps_match_jax_pallas_steps():
    jmodel, jstate, model, state = _jax_and_port_states()
    jtrain_step, jeval_step = jtrain.make_upit_waveform_steps(
        jmodel, donate_state=False, pallas_scan=True
    )
    train_step, eval_step = train.make_upit_waveform_steps(model)
    mix, sources, lengths = _waves(seed=5)
    jargs = (jnp.asarray(mix), jnp.asarray(sources), jnp.asarray(lengths))
    targs = (torch.from_numpy(mix), torch.from_numpy(sources), torch.from_numpy(lengths))
    np.testing.assert_allclose(
        eval_step(state, *targs).numpy(), np.asarray(jeval_step(jstate, *jargs)), rtol=STEP_RTOL
    )
    for _ in range(3):
        jstate, jloss = jtrain_step(jstate, *jargs)
        state, loss = train_step(state, *targs)
        np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=STEP_RTOL)
    assert state.step == 3
    want = jax.tree.map(np.asarray, jstate.params)
    got = upit_blstm_params(state.model.state_dict())
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL, atol=1e-7, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(
        eval_step(state, *targs).numpy(), np.asarray(jeval_step(jstate, *jargs)), rtol=STEP_RTOL
    )


def test_bf16_train_step_keeps_fp32_masters():
    _, _, model, state = _jax_and_port_states(dropout_rate=0.5)
    train_step, _ = train.make_upit_waveform_steps(model, compute_dtype=torch.bfloat16)
    mix, sources, lengths = _waves(seed=6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, loss = train_step(state, *map(torch.from_numpy, (mix, sources, lengths)))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(s["mu"].dtype == torch.float32 for s in state.optimizer.state.values())
    assert all(not torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_dropout_rate_and_scaling():
    h = torch.full((400, 500), 0.7)
    out = dropout(h, 0.8, torch.Generator().manual_seed(0))
    kept = out != 0
    # Bernoulli(0.2) over 200,000 values: the share is within 4.5 sigma (0.0040)
    assert abs(kept.float().mean().item() - 0.2) < 0.004
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 0.7 / 0.2))
    again = dropout(h, 0.8, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    bf = dropout(h.to(torch.bfloat16), 0.8, torch.Generator().manual_seed(1))
    assert bf.dtype == torch.bfloat16


def test_train_forward_drops_only_with_a_generator():
    model = UPitBlstm(input_size=9, output_size=9, **SMALL, generator=torch.Generator().manual_seed(0))
    mag = torch.from_numpy(np.abs(_normal((2, 11, 9), 7)))
    with torch.no_grad():
        eval_out = model.train_forward(mag)
        serve = model(mag)
        dropped = model.train_forward(mag, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(eval_out, serve, atol=1e-6, rtol=0)
    assert not torch.allclose(dropped, eval_out)


@pytest.mark.parametrize(
    "options",
    [dict(shuffle=True), dict(shuffle=True, sort_by_length=True), dict(shuffle=True, drop_remainder=True),
     dict(shuffle=False, pad_quantum_samples=1000)],
)
def test_waveform_loader_order_matches_jax(fixture_tree, options):
    split = fixture_tree / "tr"
    jl = JaxWaveformLoader(split, batch_size=2, seed=7, **options)
    tl = WaveformLoader(split, batch_size=2, seed=7, **options)
    assert len(jl) == len(tl)

    def epochs(loader, n):
        return [[b.names for b in loader] for _ in range(n)]

    assert epochs(tl, 2) == epochs(jl, 2)
    jl.set_epoch(5)
    tl.set_epoch(5)
    jb, tb = next(iter(jl)), next(iter(tl))
    assert tb.names == jb.names
    np.testing.assert_array_equal(tb.mix, jb.mix)
    np.testing.assert_array_equal(tb.frame_lengths, jb.frame_lengths)


def test_config_fields_and_defaults_match_jax(tmp_path):
    want = jax_config.UPitTrainConfig()
    got = UPitTrainConfig()
    import dataclasses

    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    path = tmp_path / "cfg.json"
    jax_config.save_config(jax_config.UPitTrainConfig(hidden=24, bf16_compute=True), path)
    loaded = load_config(UPitTrainConfig, path, {"epochs": 3, "batch_size": None})
    assert (loaded.hidden, loaded.bf16_compute, loaded.epochs, loaded.batch_size) == (24, True, 3, 2)


@pytest.mark.parametrize(
    "fields",
    [{"pack": True, "dynamic_mix": True}, {"dynamic_mix": True}, {"variant": "conv"}, {"mesh": {"data": 4}},
     {"mesh": {"model": 2}}],
)
def test_config_rejects_what_the_port_does_not_serve(tmp_path, fields):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(fields))
    with pytest.raises(ValueError, match="not served by the PyTorch port"):
        load_config(UPitTrainConfig, path)


def test_checkpoint_manager_keeps_the_best_and_restores(tmp_path):
    _, _, model, state = _jax_and_port_states()
    ckpt = train.CheckpointManager(tmp_path, max_to_keep=2)
    for step, loss in [(1, 5.0), (2, 3.0), (3, 4.0), (4, 3.5)]:
        for p in model.parameters():
            p.data.fill_(float(step))
        state.step = step
        ckpt.save_if_best(step, state, loss)
    assert ckpt.best_step == 2 and ckpt.latest_step == 4
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == ["ckpt_2.pt", "ckpt_4.pt"]
    reopened = train.CheckpointManager(tmp_path)
    reopened.restore(state)
    assert state.step == 2 and all(torch.all(p == 2.0) for p in model.parameters())
    reopened.restore_params(state, step=4)
    assert state.step == 2 and all(torch.all(p == 4.0) for p in model.parameters())
    with pytest.raises(FileNotFoundError):
        train.CheckpointManager(tmp_path / "empty").restore(state)


def test_fit_stops_on_a_non_finite_loss_and_restores_the_start(tmp_path):
    _, _, model, state = _jax_and_port_states()
    start = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []

    def train_step(state, x):
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
        calls.append(1)
        return state, torch.tensor(float("nan") if len(calls) == 3 else 1.0)

    batches = [_Batch(np.zeros(2, np.float32))] * 4
    result = train.fit(
        state, train_step, lambda s, x: torch.tensor(1.0), batches, batches, lambda b: (b[0],),
        epochs=2, nan_check_every=1, log_fn=lambda _: None,
    )
    assert result.diverged and len(calls) == 3
    assert all(torch.equal(start[k], v) for k, v in model.state_dict().items())


def test_fit_early_stops_and_resumes_the_shuffle_stream(tmp_path, fixture_tree):
    _, _, model, state = _jax_and_port_states()
    loader = WaveformLoader(fixture_tree / "tr", batch_size=2, shuffle=True, seed=1)
    vals = iter([3.0, 2.0, 2.5, 2.75, 2.875])  # exact in float32
    ckpt = train.CheckpointManager(tmp_path)
    result = train.fit(
        state, lambda s, *a: (s, torch.tensor(1.0)), lambda s, *a: torch.tensor(next(vals)),
        loader, [_Batch(np.zeros(1))], lambda b: (b[0],),
        epochs=5, patience=1, checkpoints=ckpt, log_fn=lambda _: None,
    )
    assert result.stopped_early and result.best_epoch == 2
    assert result.history["val_loss"] == [3.0, 2.0, 2.5, 2.75]
    assert ckpt.latest_step == 2
    seen = []
    loader.set_epoch = lambda epoch, _orig=loader.set_epoch: (seen.append(epoch), _orig(epoch))
    train.fit(
        state, lambda s, *a: (s, torch.tensor(1.0)), lambda s, *a: torch.tensor(1.0),
        loader, [_Batch(np.zeros(1))], lambda b: (b[0],),
        epochs=2, checkpoints=ckpt, resume=True, log_fn=lambda _: None,
    )
    assert seen == [2, 3]


def test_cli_train_then_separate(tmp_path, fixture_tree, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"hidden": 8, "num_layers": 1, "seed": 3}))
    ckpt = tmp_path / "CKPT"
    cli.main(["train", "--workload", "upit", "--config", str(cfg), "--data-root",
              str(fixture_tree), "--epochs", "2", "--checkpoint-dir", str(ckpt),
              "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["best_epoch"] in (1, 2) and np.isfinite(summary["best_val_loss"])
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    epochs = [r for r in records if "epoch" in r]
    assert [r["epoch"] for r in epochs] == [1, 2]
    assert len(records) == 2 + 2 * 3  # 5 tr utterances at batch 2: 3 steps per epoch
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert json.loads((ckpt / "train_config.json").read_text())["hidden"] == 8
    assert (ckpt / f"ckpt_{summary['best_epoch']}.pt").exists()

    # --resume continues from the newest snapshot, its step counter included
    latest = train.CheckpointManager(ckpt).latest_step
    cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "1",
              "--checkpoint-dir", str(ckpt), "--resume", "--device", "cpu"])
    assert f"resumed from checkpoint step {latest}" in capsys.readouterr().out
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert len(records) == 2 + 2 * 3 + 1 + 3 and records[-1]["step"] == 3 * latest + 3

    for flags in ([], ["--bf16"], ["--batch-size", "1", "--transfer-int16"]):
        out = tmp_path / f"sep{len(flags)}"
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(fixture_tree),
                  "--out-dir", str(out), "--device", "cpu", *flags])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["written"] == 4
        for wav in sorted(out.glob("*.wav")):
            data, rate = read_wav(wav)
            assert rate == 8000 and len(data) > 0 and np.isfinite(data).all()


def test_cli_rejects_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="no separator checkpoint"):
        cli.main(["separate", "--checkpoint-dir", str(tmp_path), "--device", "cpu"])


def test_params_round_trip_through_weights(tmp_path):
    jmodel = JaxUPitBlstm(input_size=9, output_size=9, **SMALL)
    x = jnp.asarray(np.abs(_normal((2, 13, 9), 8)))
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(0), x)["params"])
    model = UPitBlstm(input_size=9, output_size=9, **SMALL)
    model.load_state_dict(upit_blstm_state_dict(params))
    back = upit_blstm_params(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # a port-trained tree runs in the JAX model: shift every weight, convert back
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
        want = model(torch.tensor(np.asarray(x))).numpy()
    got = np.asarray(jmodel.apply({"params": upit_blstm_params(model.state_dict())}, x))
    np.testing.assert_allclose(got, want, atol=1e-5)
