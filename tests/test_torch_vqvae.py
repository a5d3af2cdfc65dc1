"""PyTorch port, the VQ-VAE codec family against the JAX reference on the CPU:
flax "SAME" Conv and ConvTranspose, the five codecs' forward passes, ``codes``
and ``decode_codes`` at small widths with their parameter counts pinned, the
committed trained t3tok checkpoint (its ``.npz`` against the orbax
checkpoint, and the port's codes and reconstructions against JAX's on
fixture audio), ``make_vae_steps`` and ``VaeLoader``.

Weights come from the JAX modules' ``init`` (or the trained checkpoint) and
reach the port through ``weights.vqvae_state_dict``; inputs are made with
numpy from a seed and handed to both sides. Every nearest-code search on the
port's side runs the ``nearest_code`` kernel's plain version (CPU tensors).
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from speech_separation_tpu import train as jtrain
from speech_separation_tpu.data import VaeLoader as JaxVaeLoader
from speech_separation_tpu.losses import summed_squared_error as jax_sse
from speech_separation_tpu.models import vqvae as jvqvae
from speech_separation_tpu_torch import cli, train
from speech_separation_tpu_torch.data.audio_io import read_normalized
from speech_separation_tpu_torch.data.datasets import VaeLoader
from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
from speech_separation_tpu_torch.losses import summed_squared_error
from speech_separation_tpu_torch.models import vqvae
from speech_separation_tpu_torch.models.tasnet import conv_same, conv_transpose_same
from speech_separation_tpu_torch.weights import load_params_npz, vqvae_params, vqvae_state_dict

ROOT = pathlib.Path(__file__).resolve().parent.parent
TRAINED = ROOT / "artifacts" / "t3tok_hard"
NPZ = TRAINED / "params_ep38.npz"
# fp32 against fp32, sums in another order (conv algorithms differ): outputs
# measured at ~1e-7 relative, so 1e-5 of the largest |value|
FWD_REL = 1e-5
# The auxiliary losses: the codebook terms are means of squares (1e-6); the
# Gumbel KL is a small difference of sums over T·K terms, where fp32
# cancellation measured 1.4e-5 relative, so 1e-4
AUX_RTOL = 1e-4
# The trained t3tok on fixture audio: codes equal at >= 99.9% of positions;
# a position that differs is a near tie: the two codes' float64 squared
# distances to the port's residual within 1e-5 of ‖r‖² + max ‖e‖² (fp32 dot
# products over 16 or 64 terms in another order, on latents that differ by
# the encoders' fp32 rounding)
CODE_MATCH = 0.999
NEAR_TIE_REL = 1e-5
DECODE_REL_L2 = 1e-5  # the port's decoder on JAX's codes, against JAX's
SDR_DB = 0.05  # reconstruction SI-SDR from codes, port against JAX
# Two train steps (NAdam / Adam 1e-3): losses to 1e-5 relative; each kind of
# parameter leaf's update (after - before) to 1e-4 relative L2. Adam's
# update is ~lr · g / |g|, insensitive to the gradients' 1e-6 fp32 noise.
STEP_LOSS_RTOL = 1e-5
UPDATE_REL_L2 = 1e-4

SMALL = {
    "gumbel": (dict(latent_dim=16), (2, 128, 1)),
    "v2": (dict(embedding_dim=8, num_embeddings=16), (2, 13, 40)),
    "t2": (dict(embedding_dim=8, num_embeddings=16), (2, 16, 40)),
    "t3": (dict(embedding_dim=8, num_embeddings=16), (2, 24, 40)),
    "t3tok": (dict(embedding_dim=8, num_embeddings=16, skip_embeddings=16, skip_pq=4), (2, 24, 40)),
}
CLASSES = {
    "gumbel": (jvqvae.VqVaeGumbel, vqvae.VqVaeGumbel),
    "v2": (jvqvae.VqVaeCodebook, vqvae.VqVaeCodebook),
    "t2": (jvqvae.VqVaeT2, vqvae.VqVaeT2),
    "t3": (jvqvae.VqVaeT3, vqvae.VqVaeT3),
    "t3tok": (jvqvae.VqVaeT3Tok, vqvae.VqVaeT3Tok),
}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _assert_close(got, want, rel=FWD_REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def _si_sdr(est, ref):
    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    target = (est @ ref) / (ref @ ref) * ref
    return 10 * np.log10((target @ target) / ((est - target) @ (est - target)))


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("width", [1, 3, 4])
@pytest.mark.parametrize("length", [7, 8])
def test_same_padding_matches_flax(length, width, stride, transpose):
    x = _normal((2, length, 5), 1)
    cls = fnn.ConvTranspose if transpose else fnn.Conv
    layer = cls(6, (width,), strides=(stride,), padding="SAME")
    params = jax.tree.map(np.array, layer.init(jax.random.key(0), jnp.asarray(x))["params"])
    params["bias"] = _normal((6,), 2)
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    kernel, bias = torch.from_numpy(params["kernel"]), torch.from_numpy(params["bias"])
    xt = torch.from_numpy(x)
    if transpose:
        got = conv_transpose_same(xt.transpose(1, 2), kernel, bias, stride).transpose(1, 2)
    else:
        got = conv_same(xt, kernel, bias, stride)
    assert want.shape == (2, length * stride if transpose else -(-length // stride), 6)
    _assert_close(got.numpy(), want)


def _pair(variant, seed=0):
    kw, shape = SMALL[variant]
    jcls, cls = CLASSES[variant]
    x = _normal(shape, seed + 10, 0.5)
    jmodel = jcls(**kw)
    params = jax.jit(jmodel.init)({"params": jax.random.key(seed), "gumbel": jax.random.key(1)},
                                  jnp.asarray(x))["params"]
    params = jax.tree.map(np.array, params)
    model = cls(**kw)
    model.load_state_dict(vqvae_state_dict(params))
    return x, jmodel, params, model.eval()


@pytest.mark.parametrize("variant", list(SMALL))
def test_codec_forward_codes_and_decode_match_jax(variant):
    x, jmodel, params, model = _pair(variant)
    variables = {"params": params}
    jx = jnp.asarray(x)
    xt = torch.from_numpy(x)
    apply = jax.jit(jmodel.apply, static_argnames=("deterministic", "method"))
    back = vqvae_params(model.state_dict())  # the rename both ways
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    want, jaux = apply(variables, jx, deterministic=True)
    with torch.no_grad():
        got, aux = model(xt, deterministic=True)
    _assert_close(got.numpy(), want)
    np.testing.assert_allclose([a.item() for a in aux], [float(a) for a in jaux], rtol=AUX_RTOL)
    cls = type(jmodel)
    if not hasattr(cls, "codes"):
        return
    jcodes = apply(variables, jx, method=cls.codes)
    with torch.no_grad():
        codes = model.codes(xt)
    for got_c, want_c in zip(codes if isinstance(codes, tuple) else (codes,),
                             jcodes if isinstance(jcodes, tuple) else (jcodes,)):
        assert got_c.dtype == torch.int32 and got_c.shape == want_c.shape
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    with torch.no_grad():
        if variant == "t3tok":
            recon = model.decode_codes(*codes)
            jrecon = apply(variables, *jcodes, method=cls.decode_codes)
            _assert_close(recon.numpy(), got.numpy())  # codes alone reproduce the forward
        elif variant == "t3":
            e1 = jnp.tanh(jmodel.apply(variables, jx, method=lambda m, v: m.encoder1(v)))
            recon = model.decode_codes(codes, torch.from_numpy(np.array(e1)))
            jrecon = apply(variables, jcodes, e1, method=cls.decode_codes)
        elif variant == "gumbel":
            recon = model.decode_codes(codes)
            jrecon = apply(variables, jcodes, method=cls.decode_codes)
        else:
            return
    _assert_close(recon.numpy(), jrecon)


@pytest.mark.parametrize(
    "variant,kw,count",
    [
        ("gumbel", dict(latent_dim=1024), 5_148_897),  # `vq-vae_for_1d_data.ipynb cell 22`
        ("t3", {}, 193_000),  # `_t3 cell 34`
        ("t3tok", dict(skip_pq=4), 307_880),  # artifacts/t3tok_hard/train_config.json
    ],
)
def test_parameter_counts_are_pinned(variant, kw, count):
    assert sum(p.numel() for p in CLASSES[variant][1](**kw).parameters()) == count


@pytest.fixture(scope="module")
def trained_params():
    """The committed t3tok checkpoint restored through the JAX package (orbax)."""
    spec = importlib.util.spec_from_file_location("export_vae_params",
                                                  ROOT / "scripts" / "export_vae_params.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.restore_flat_params(TRAINED / "ckpt_ep38.tgz")


def test_committed_npz_equals_the_orbax_checkpoint(trained_params):
    with np.load(NPZ) as payload:
        assert sorted(payload.files) == sorted(trained_params)
        for name, value in trained_params.items():
            assert payload[name].dtype == np.float32
            np.testing.assert_array_equal(payload[name], value, err_msg=name)
    assert sum(v.size for v in trained_params.values()) == 307_880


@pytest.fixture(scope="module")
def trained_codec(trained_params, tmp_path_factory):
    """(JAX model, its params from orbax, the port's model from the npz, 2
    fixture utterances as frame-stacked inputs with their lengths)."""
    cfg = json.loads((TRAINED / "train_config.json").read_text())
    kw = {k: cfg[k] for k in ("embedding_dim", "num_embeddings", "skip_embeddings",
                              "deep_depth", "skip_depth", "skip_pq")}
    jmodel = jvqvae.VqVaeT3Tok(**kw)
    params = vqvae_params(vqvae_state_dict(trained_params))
    model = vqvae.VqVaeT3Tok(**kw)
    model.load_state_dict(load_params_npz(NPZ))
    root = make_synthetic_fixture(tmp_path_factory.mktemp("t3tok_fixture"),
                                  utterances_per_split={"tr": 0, "cv": 0, "tt": 2},
                                  min_seconds=2.0, max_seconds=3.0, seed=7, profile="hard")
    wavs = []
    for name in (root / "lists" / "tt_wav.lst").read_text().split():
        wav = read_normalized(root / "tt" / "s1" / name, cfg["sample_rate"])
        wavs.append((wav, cli._stack_frames(wav, "t3tok")))
    return jmodel, params, model.eval(), wavs


def _stage_near_ties(model, frames, got, want):
    """Positions where the port's and JAX's codes differ, each checked to be a
    near tie on the port's residual; positions where an earlier stage already
    differs follow from that flip and are counted, not checked."""
    with torch.no_grad():
        skip, e3 = model._encode(torch.from_numpy(frames))
    mismatches = 0
    for latent, rvq, g_codes, w_codes in ((e3, model.vq1, got[0], want[0]),
                                          (skip, model.vq2, got[1], want[1])):
        cb = rvq.embeddings.detach().double().numpy()  # [depth, pq, D/pq, K]
        depth, pq, sub = cb.shape[:3]
        flat = latent.double().numpy().reshape(-1, pq * sub)
        g_codes = g_codes.reshape(-1, depth * pq)
        w_codes = np.asarray(w_codes).reshape(-1, depth * pq)
        residual = flat.copy()
        for d in range(depth):
            agree_before = np.all(g_codes[:, : d * pq] == w_codes[:, : d * pq], axis=1)
            for g in range(pq):
                col = d * pq + g
                r = residual[:, g * sub : (g + 1) * sub]
                bad = np.nonzero(g_codes[:, col] != w_codes[:, col])[0]
                mismatches += len(bad)
                for i in bad[agree_before[bad]]:
                    e_g, e_w = cb[d, g][:, g_codes[i, col]], cb[d, g][:, w_codes[i, col]]
                    gap = abs(((r[i] - e_g) ** 2).sum() - ((r[i] - e_w) ** 2).sum())
                    scale = (r[i] ** 2).sum() + (cb[d, g] ** 2).sum(0).max()
                    assert gap <= NEAR_TIE_REL * scale, (d, g, i, gap, scale)
            q = np.concatenate([cb[d, g][:, g_codes[:, d * pq + g]].T for g in range(pq)], axis=1)
            residual = residual - q
    return mismatches


def test_trained_codes_and_reconstruction_match_jax(trained_codec):
    jmodel, params, model, wavs = trained_codec
    total = mismatched = 0
    for wav, frames in wavs:
        jcodes = jmodel.apply({"params": params}, jnp.asarray(frames), method=jvqvae.VqVaeT3Tok.codes)
        with torch.no_grad():
            codes = model.codes(torch.from_numpy(frames))
        got = tuple(c.numpy() for c in codes)
        want = tuple(np.asarray(c) for c in jcodes)
        assert [g.shape for g in got] == [w.shape for w in want]
        total += sum(g.size for g in got)
        mismatched += _stage_near_ties(model, frames, got, want)

        # the port's decoder on JAX's codes
        jrecon = np.asarray(jmodel.apply({"params": params}, *jcodes,
                                         method=jvqvae.VqVaeT3Tok.decode_codes))
        with torch.no_grad():
            recon = model.decode_codes(*(torch.from_numpy(w) for w in want)).numpy()
            own = model.decode_codes(*codes).numpy()
        assert _rel(recon, jrecon) <= DECODE_REL_L2
        # reconstruction from codes alone, each side from its own codes
        sdr = _si_sdr(own.reshape(-1)[: len(wav)], wav)
        jsdr = _si_sdr(jrecon.reshape(-1)[: len(wav)], wav)
        # the trained codec reconstructs: random weights give <= 0 dB
        assert abs(sdr - jsdr) <= SDR_DB and sdr > 5.0, (sdr, jsdr)
    assert 1 - mismatched / total >= CODE_MATCH, (mismatched, total)


def _step_pair(variant, seed):
    x, jmodel, params, model = _pair(variant, seed)
    targets = np.zeros((x.shape[0], x.shape[1] * x.shape[2], 1), np.float32)
    targets[:, :, 0] = x.reshape(x.shape[0], -1)
    return x, targets, jmodel, params, model


@pytest.mark.parametrize("variant", ["t3", "t3tok"])
def test_make_vae_steps_match_jax(variant):
    x, targets, jmodel, params, model = _step_pair(variant, 3)

    def jloss(preds, t):
        return jax_sse(preds.reshape(preds.shape[0], -1, 1), t)

    def loss(preds, t):
        return summed_squared_error(preds.reshape(preds.shape[0], -1, 1), t)

    jstep, jeval = jtrain.make_vae_steps(jmodel, jloss, donate_state=False)
    jstate = jtrain.TrainState.create(jmodel.apply, params, jtrain.nadam(1e-3), jax.random.key(0))
    model.train()
    step, evaluate = train.make_vae_steps(model, loss)
    state = train.TrainState.create(model, train.nadam(1e-3), seed=0)
    before = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    xt, tt = torch.from_numpy(x), torch.from_numpy(targets)
    for _ in range(2):
        jstate, jl, jrecon = jstep(jstate, jnp.asarray(x), jnp.asarray(targets))
        state, l, recon = step(state, xt, tt)
        np.testing.assert_allclose([l.item(), recon.item()], [float(jl), float(jrecon)],
                                   rtol=STEP_LOSS_RTOL)
    jl, jrecon, jpreds = jeval(jstate, jnp.asarray(x), jnp.asarray(targets))
    l, recon, preds = evaluate(state, xt, tt)
    np.testing.assert_allclose([l.item(), recon.item()], [float(jl), float(jrecon)],
                               rtol=STEP_LOSS_RTOL)
    after = vqvae_state_dict(jax.tree.map(np.asarray, jstate.params))
    kinds = {}
    for name, value in model.state_dict().items():
        kind = name.rsplit(".", 1)[-1]  # kernel, bias, embeddings
        got, want = value.numpy() - before[name], after[name].numpy() - before[name]
        kinds.setdefault(kind, []).append((got.ravel(), want.ravel()))
    assert set(kinds) == {"kernel", "bias", "embeddings"}
    for kind, pairs in kinds.items():
        got, want = (np.concatenate(p) for p in zip(*pairs))
        assert np.abs(want).max() > 0
        assert _rel(got, want) <= UPDATE_REL_L2, kind


@pytest.fixture(scope="module")
def loader_tree(tmp_path_factory):
    return make_synthetic_fixture(tmp_path_factory.mktemp("vae_loader"), utterances_per_split=5,
                                  min_seconds=0.4, max_seconds=1.3, seed=3)


@pytest.mark.parametrize("stacked,alignment", [(False, 4), (True, 4), (True, 8)])
def test_vae_loader_batches_match_jax(loader_tree, stacked, alignment):
    kw = dict(batch_size=2, stacked=stacked, stride_alignment=alignment, shuffle=True, seed=4,
              pad_quantum_seconds=0.5)
    port, ref = VaeLoader(loader_tree / "tr", **kw), JaxVaeLoader(loader_tree / "tr", **kw)
    assert len(port) == len(ref) == 3
    for epoch in range(2):
        if epoch:
            port.set_epoch(5)
            ref.set_epoch(5)
        batches = list(zip(port, ref, strict=True))
        assert len(batches) == 3
        for got, want in batches:
            assert got.names == want.names
            for field in ("inputs", "targets", "lengths"):
                a, b = getattr(got, field), getattr(want, field)
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
            if stacked:
                assert got.inputs.shape[1] % alignment == 0
