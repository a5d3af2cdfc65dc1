"""PyTorch port, Conv-TasNet training against the JAX reference on the CPU:
``pit_si_sdr_loss``, ``make_time_domain_steps`` in its three settings (fp32
module, bf16 module, the kernel trunk, whose wrappers take their plain
versions on a CPU tensor), ``cli train`` for ``variant="tasnet"``, the weight
bridge both ways for a trained model, and the refusals (a causal model through
the kernel trunk, ``--device cuda`` without a GPU).

Inputs are made with numpy from a seed and handed to both sides.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu import train as jtrain
from speech_separation_tpu.losses.pit import pit_si_sdr_loss as jax_pit_si_sdr_loss
from speech_separation_tpu.models import ConvTasNet as JaxConvTasNet
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.audio_io import read_wav
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.losses import pit_si_sdr_loss
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import train_apply
from speech_separation_tpu_torch.weights import convtasnet_params, convtasnet_state_dict

TINY = dict(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3, blocks=3,
            repeats=2)
LR = 1e-3
LOSS_RTOL = 1e-5  # pit_si_sdr_loss, and the fp32 steps' losses (measured 7e-8)
# After 2 Adam steps, the update (params - init) against JAX's, SNR over each
# kind of leaf (gLN gamma and beta, PReLU alpha, convolution kernel and bias),
# so that a fault confined to a small kind cannot hide under the others. fp32:
# the same math (measured 107 to 257 dB). bf16 and the kernel trunk: the two
# frameworks round at other places; Adam divides by the root of the second
# moment, so a small gradient whose sign flips moves its parameter by up to
# 2 lr per step either way. Measured, bf16 module / kernel trunk: gamma 12.0 /
# 14.2, beta 10.8 / 14.7, kernel 11.8 / 13.2, bias 12.5 / 13.6 dB; alpha 37.7
# / 39.1 dB (13 scalars with large gradients, none flips); losses within
# 3.2e-3 relative, no parameter 4 lr apart.
LEAVES = ("gamma", "beta", "alpha", "kernel", "bias")
UPDATE_DB = {"fp32": dict.fromkeys(LEAVES, 80.0),
             "bf16": {**dict.fromkeys(LEAVES, 8.0), "alpha": 30.0},
             "kernel": {**dict.fromkeys(LEAVES, 8.0), "alpha": 30.0}}
STEP_LOSS_RTOL = {"fp32": 1e-5, "bf16": 1e-2, "kernel": 1e-2}
MAX_UPDATE_GAP = 4.5 * LR  # two steps, each at most ~2 lr apart


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


@pytest.mark.parametrize("speakers", [2, 3])
def test_pit_si_sdr_loss_matches_jax(speakers):
    rng = np.random.default_rng(speakers)
    refs = rng.standard_normal((3, speakers, 700)).astype(np.float32)
    # estimates near a permutation of the references, ragged valid lengths
    perm = rng.permutation(speakers)
    est = (refs[:, perm] + 0.3 * rng.standard_normal(refs.shape)).astype(np.float32)
    lengths = np.array([700, 513, 64], np.int32)
    refs[1, :, 513:] = 0.0
    refs[2, :, 64:] = 0.0
    want = float(jax_pit_si_sdr_loss(jnp.asarray(est), jnp.asarray(refs), jnp.asarray(lengths)))
    got = pit_si_sdr_loss(torch.from_numpy(est), torch.from_numpy(refs), torch.from_numpy(lengths))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    # est == refs: the explicit subtraction keeps the score finite and high
    perfect = pit_si_sdr_loss(torch.from_numpy(refs), torch.from_numpy(refs),
                              torch.from_numpy(lengths))
    want = float(jax_pit_si_sdr_loss(jnp.asarray(refs), jnp.asarray(refs), jnp.asarray(lengths)))
    assert np.isfinite(perfect.item()) and perfect.item() < -60.0
    np.testing.assert_allclose(perfect.item(), want, rtol=1e-3)


def test_pit_si_sdr_loss_gradient_matches_jax():
    rng = np.random.default_rng(5)
    refs = rng.standard_normal((2, 2, 300)).astype(np.float32)
    est = (refs[:, ::-1] + 0.5 * rng.standard_normal(refs.shape)).astype(np.float32)
    lengths = np.array([300, 211], np.int32)
    want = jax.grad(lambda e: jax_pit_si_sdr_loss(e, jnp.asarray(refs), jnp.asarray(lengths)))(
        jnp.asarray(est))
    e = torch.from_numpy(est.copy()).requires_grad_()
    pit_si_sdr_loss(e, torch.from_numpy(refs), torch.from_numpy(lengths)).backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    assert not e.grad[1, :, 211:].any()  # past the valid length: masked out


@functools.lru_cache(maxsize=None)
def _batch_and_params():
    rng = np.random.default_rng(0)
    t = np.arange(1024) / 8000.0
    tones = np.stack([np.sin(2 * np.pi * 200 * t), 0.5 * np.sign(np.sin(2 * np.pi * 1300 * t))])
    sources = np.concatenate([0.3 * tones[None], 0.1 * rng.standard_normal((1, 2, 1024))])
    sources = sources.astype(np.float32)
    sources[1, :, 900:] = 0.0
    lengths = np.array([1024, 900], np.int32)
    jmodel = JaxConvTasNet(**TINY)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 1024)))["params"]
    # init leaves gamma 1 and beta, biases 0: perturb every leaf
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    return (sources.sum(axis=1), sources, lengths), params


def _jax_steps(setting):
    (mix, sources, lengths), params = _batch_and_params()
    jmodel = JaxConvTasNet(**TINY)
    state = jtrain.TrainState.create(jmodel.apply, jax.tree.map(jnp.asarray, params),
                                     jtrain.adam(LR), jax.random.key(0))
    ts, ev = jtrain.make_time_domain_steps(
        jmodel, donate_state=False, compute_dtype=None if setting == "fp32" else jnp.bfloat16,
        pallas_trunk=setting == "kernel")
    arrays = tuple(map(jnp.asarray, (mix, sources, lengths)))
    losses = []
    for _ in range(2):
        state, loss = ts(state, *arrays)
        losses.append(float(loss))
    losses.append(float(ev(state, *arrays)))
    return losses, convtasnet_state_dict(jax.tree.map(np.asarray, state.params))


def _port_steps(setting):
    (mix, sources, lengths), params = _batch_and_params()
    model = ConvTasNet(**TINY)
    model.load_state_dict(convtasnet_state_dict(params))
    state = train.TrainState.create(model, train.adam(LR), seed=0)
    ts, ev = train.make_time_domain_steps(
        model, compute_dtype=None if setting == "fp32" else torch.bfloat16,
        pallas_trunk=setting == "kernel")
    arrays = tuple(torch.from_numpy(a) for a in (mix, sources, lengths))
    losses = [ts(state, *arrays)[1].item() for _ in range(2)]
    losses.append(ev(state, *arrays).item())
    return losses, model.state_dict()


@pytest.mark.parametrize("setting", ["fp32", "bf16", "kernel"])
def test_time_domain_steps_match_jax(setting):
    want_losses, want = _jax_steps(setting)
    got_losses, got = _port_steps(setting)
    np.testing.assert_allclose(got_losses, want_losses, rtol=STEP_LOSS_RTOL[setting])
    assert got_losses[-1] < got_losses[0]
    init = convtasnet_state_dict(_batch_and_params()[1])
    assert set(got) == set(want) == set(init)
    for leaf in LEAVES:
        keys = [k for k in init if k.rsplit(".", 1)[-1] == leaf]
        du_got = torch.cat([(got[k] - init[k]).flatten() for k in keys]).double()
        du_want = torch.cat([(want[k] - init[k]).flatten() for k in keys]).double()
        assert _snr_db(du_want.numpy(), du_got.numpy()) >= UPDATE_DB[setting][leaf], leaf
        assert (du_got - du_want).abs().max().item() <= MAX_UPDATE_GAP, leaf
    assert {k.rsplit(".", 1)[-1] for k in init} == set(LEAVES)


def test_kernel_path_gradients_reach_every_parameter():
    """train_apply's gradients (kernel trunk in bf16) land on every parameter
    and agree with the bf16 module's autograd, as the two bf16 paths can."""
    (mix, sources, lengths), params = _batch_and_params()
    grads = {}
    for kind in ("kernel", "module"):
        model = ConvTasNet(**TINY)
        model.load_state_dict(convtasnet_state_dict(params))
        if kind == "kernel":
            est = train_apply(model, torch.from_numpy(mix))
        else:
            cast = {n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
            est = torch.func.functional_call(model, cast, (torch.from_numpy(mix),))
        pit_si_sdr_loss(est.float(), torch.from_numpy(sources), torch.from_numpy(lengths)).backward()
        grads[kind] = {n: p.grad for n, p in model.named_parameters()}
    # the module's autograd leaves the last block's residual output out of the
    # graph (its h feeds nothing); the kernel trunk returns zeros for it
    last = f"tcn_{TINY['repeats'] - 1}_{TINY['blocks'] - 1}.res_out."
    assert all(g is not None and g.dtype == torch.float32 for g in grads["kernel"].values())
    for name in (last + "kernel", last + "bias"):
        assert grads["module"][name] is None and not grads["kernel"][name].any()
        grads["module"][name] = torch.zeros_like(grads["kernel"][name])
    flat = {k: torch.cat([g.flatten() for g in v.values()]).numpy() for k, v in grads.items()}
    assert _snr_db(flat["module"], flat["kernel"]) >= 10.0  # bf16 pair, measured ~15 to 20 dB


def test_causal_model_refuses_the_kernel_trunk():
    model = ConvTasNet(**TINY, causal=True)
    with pytest.raises(ValueError, match="causal ConvTasNet must train via the module path"):
        train.make_time_domain_steps(model, compute_dtype=torch.bfloat16, pallas_trunk=True)
    with pytest.raises(ValueError, match="gLN topology"):
        train_apply(model, torch.zeros(1, 1024))
    # the module path trains it
    state = train.TrainState.create(model, train.adam(LR), seed=0)
    ts, _ = train.make_time_domain_steps(model)
    (mix, sources, lengths), _ = _batch_and_params()
    loss = ts(state, *(torch.from_numpy(a) for a in (mix, sources, lengths)))[1]
    assert np.isfinite(loss.item())


@pytest.fixture(scope="module")
def fixture_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("tasnet_train_fixture"),
                                  utterances_per_split=2, min_seconds=0.4, max_seconds=1.0, seed=3)


def _tasnet_cfg(path, **extra):
    path.write_text(json.dumps({
        "variant": "tasnet", "batch_size": 2, "seed": 0, "learning_rate": LR,
        "tasnet_enc_dim": TINY["enc_dim"], "tasnet_bottleneck": TINY["bottleneck"],
        "tasnet_hidden": TINY["hidden"], "tasnet_blocks": TINY["blocks"],
        "tasnet_repeats": TINY["repeats"], **extra,
    }))
    return path


@pytest.mark.parametrize("pallas_trunk", [False, True])
def test_cli_train_tasnet_then_separate(fixture_tree, tmp_path, capsys, pallas_trunk):
    cfg = _tasnet_cfg(tmp_path / "cfg.json", tasnet_pallas_trunk=pallas_trunk)
    ckpt = tmp_path / "ckpt"
    cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "2",
              "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["device"] == "cpu" and np.isfinite(summary["best_val_loss"])
    saved = json.loads((ckpt / "train_config.json").read_text())
    assert saved["variant"] == "tasnet" and saved["tasnet_pallas_trunk"] == pallas_trunk
    records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records if "epoch" in r] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert (ckpt / f"ckpt_{summary['best_epoch']}.pt").exists()
    for kernel in ("pallas", "xla"):
        out = tmp_path / f"sep_{kernel}"
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(fixture_tree),
                  "--out-dir", str(out), "--kernel", kernel, "--device", "cpu"])
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["written"] == 4
        for wav in sorted(out.glob("*.wav")):
            data, rate = read_wav(wav)
            assert rate == 8000 and len(data) > 0 and np.isfinite(data).all()


def test_cli_train_tasnet_uses_plain_adam(fixture_tree, tmp_path, monkeypatch):
    """The JAX CLI's optimizer choice: plain Adam for Conv-TasNet unless the
    cosine schedule is asked for (the BLSTM keeps the staircase decay)."""
    built = []
    for name in ("adam", "cosine_adam", "exponential_decay_adam"):
        original = getattr(train, name)
        monkeypatch.setattr(train, name, lambda *a, _n=name, _f=original, **k: (built.append(_n),
                                                                                 _f(*a, **k))[1])
    for extra, want in (({}, "adam"), ({"lr_schedule": "cosine"}, "cosine_adam")):
        cfg = _tasnet_cfg(tmp_path / f"cfg_{want}.json", **extra)
        cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "1",
                  "--checkpoint-dir", str(tmp_path / want), "--device", "cpu"])
        assert built[-1] == want


@pytest.mark.parametrize("command", ["train", "separate"])
def test_cli_refuses_to_run_without_a_gpu_unless_asked_for_the_cpu(fixture_tree, tmp_path,
                                                                   monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tasnet_cfg(tmp_path / "cfg.json")
    ckpt, out = tmp_path / "ckpt", tmp_path / "sep"
    if command == "train":
        argv = ["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "1",
                "--checkpoint-dir", str(ckpt)]
    else:
        cli.main(["train", "--config", str(cfg), "--data-root", str(fixture_tree), "--epochs", "1",
                  "--checkpoint-dir", str(ckpt), "--device", "cpu"])
        argv = ["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(fixture_tree),
                "--out-dir", str(out)]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(SystemExit, match="torch.cuda.is_available") as info:
            cli.main(argv + device)
        assert info.value.code not in (0, None)
    if command == "train":
        assert not ckpt.exists()
    else:
        assert not out.exists()


def test_weight_bridge_carries_a_trained_model_both_ways():
    """A JAX tree goes into the port; the port trains it a few steps; its
    state_dict goes back to a flax tree that the JAX ConvTasNet runs, and the
    two agree."""
    (mix, sources, lengths), params = _batch_and_params()
    model = ConvTasNet(**TINY)
    model.load_state_dict(convtasnet_state_dict(params))
    jmodel = JaxConvTasNet(**TINY)
    with torch.no_grad():
        before = model(torch.from_numpy(mix)).numpy()
    assert _snr_db(np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix))), before) >= 90.0
    state = train.TrainState.create(model, train.adam(1e-2), seed=0)
    ts, _ = train.make_time_domain_steps(model)
    for _ in range(3):
        ts(state, *(torch.from_numpy(a) for a in (mix, sources, lengths)))
    tree = convtasnet_params(model.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    with torch.no_grad():
        after = model(torch.from_numpy(mix)).numpy()
    assert _snr_db(before, after) < 60.0  # training moved it
    want = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(mix)))
    assert _snr_db(want, after) >= 90.0
