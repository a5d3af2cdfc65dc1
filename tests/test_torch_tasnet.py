"""PyTorch port, Conv-TasNet serving against the JAX reference on the CPU: the
module, the folded serving path, the trunk's stacks and plain version, and
``cuda_apply`` (whose trunk runs its plain version on a CPU tensor).

Weights come from the JAX module's ``init`` with every norm, bias and PReLU
slope perturbed by seeded numpy noise (init leaves gamma = 1 and beta, biases
= 0, which would leave the folds untested), and reach the port through
``weights.convtasnet_state_dict``.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import ConvTasNet as JaxConvTasNet
from speech_separation_tpu.models import tasnet_serving as jserving
from speech_separation_tpu.ops import tcn_pallas as jtcn
from speech_separation_tpu.ops import tcn_train_pallas as jtcn_train
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply, fused_apply
from speech_separation_tpu_torch.ops import plain_versions, tcn_cuda
from speech_separation_tpu_torch.weights import convtasnet_params, convtasnet_state_dict

# small but with every dilation path (up to 2^(blocks-1) = 8 on K = 128 frames)
SMALL = dict(num_speakers=2, enc_dim=64, bottleneck=32, hidden=48, kernel=3, blocks=4, repeats=2)
FP32_DB = 90.0  # the same math in fp32, sums in another order (measured ~128 dB)
# Two bf16 pipelines (or bf16 against fp32) differ by bf16 roundings that flip
# one ulp (2^-8 relative) somewhere and are carried through 8 blocks: ~40 dB
# measured on both sides, so 30 dB leaves 10 dB of margin.
BF16_PAIR_DB = 30.0
TRUNK_DB = 40.0  # the trunk alone, plain vs Pallas in bf16 (measured ~50 dB at K = 130)
PALLAS_DB = 22.0  # bf16 serving against the fp32 module (tests/test_tasnet_serving.py)


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


def _perturb(params, seed):
    rng = np.random.default_rng(seed)
    scale = {"gamma": 0.2, "beta": 0.1, "bias": 0.1, "alpha": 0.05}

    def one(path, x):
        x = np.asarray(x, np.float32)
        s = scale.get(path[-1].key, 0.0)
        return x + s * rng.standard_normal(x.shape).astype(np.float32) if s else x

    return jax.tree_util.tree_map_with_path(one, params)


@functools.lru_cache(maxsize=None)
def _setup(win: int = 16, causal: bool = False, samples: int = 1024):
    cfg = dict(SMALL, win=win)
    jmodel = JaxConvTasNet(**cfg, causal=causal)
    mix = (0.3 * np.random.default_rng(1).standard_normal((3, samples))).astype(np.float32)
    params = _perturb(jmodel.init(jax.random.key(0), jnp.asarray(mix))["params"], seed=2)
    model = ConvTasNet(**cfg, causal=causal).eval()
    model.load_state_dict(convtasnet_state_dict(params))
    return cfg, jmodel, params, model, mix


def _port(model, mix, dtype=None):
    net = model if dtype is None else copy.deepcopy(model).to(dtype)
    with torch.no_grad():
        return net(torch.from_numpy(mix)).numpy()


@pytest.mark.parametrize("win", [16, 32])
def test_convtasnet_fp32_matches_jax(win):
    _, jmodel, params, model, mix = _setup(win)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    got = _port(model, mix)
    assert got.shape == want.shape == (3, 2, 1024) and got.dtype == np.float32
    assert _snr_db(want, got) >= FP32_DB


def test_causal_convtasnet_matches_jax():
    _, jmodel, params, model, mix = _setup(16, causal=True)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    assert _snr_db(want, _port(model, mix)) >= FP32_DB
    # causal: the output before a frame ignores everything after it (up to
    # the decoder's win-sample reach), unlike gLN's whole-utterance statistics
    late = mix.copy()
    late[:, 640:] += 1.0
    assert np.allclose(_port(model, late)[..., :600], _port(model, mix)[..., :600], atol=1e-5)


@pytest.mark.parametrize("win", [16, 32])
def test_bf16_convtasnet_is_as_close_to_fp32_as_jax_bf16(win):
    _, jmodel, params, model, mix = _setup(win)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    jax_bf16 = np.asarray(jmodel.clone(dtype=jnp.bfloat16).apply({"params": params}, jnp.asarray(mix)))
    got = _port(model, mix, torch.bfloat16)
    assert got.dtype == np.float32
    # within 3 dB of JAX's own bf16 module against the same fp32 oracle
    assert _snr_db(ref, got) >= _snr_db(ref, jax_bf16) - 3.0 > BF16_PAIR_DB


@pytest.mark.parametrize("win", [16, 32])
def test_fused_apply_matches_jax_fused_apply(win):
    cfg, _, params, model, mix = _setup(win)
    want = np.asarray(jserving.fused_apply(params, jnp.asarray(mix), dtype=None, **cfg))
    got = fused_apply(model, torch.from_numpy(mix), dtype=None).numpy()
    assert _snr_db(want, got) >= FP32_DB
    assert _snr_db(_port(model, mix), got) >= FP32_DB
    # the SAME-padding edge correction: the frames within the largest
    # dilation's reach of either end match the module (JAX's own check)
    edge = 2 ** (cfg["blocks"] - 1) * (win // 2) * 2
    module = _port(model, mix)
    np.testing.assert_allclose(got[..., :edge], module[..., :edge], atol=2e-4)
    np.testing.assert_allclose(got[..., -edge:], module[..., -edge:], atol=2e-4)


def test_fused_apply_bf16_matches_jax_fused_apply_bf16():
    cfg, jmodel, params, model, mix = _setup(16)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    want = np.asarray(jserving.fused_apply(params, jnp.asarray(mix), **cfg))
    got = fused_apply(model, torch.from_numpy(mix)).numpy()
    assert _snr_db(want, got) >= BF16_PAIR_DB
    assert _snr_db(ref, got) >= _snr_db(ref, want) - 3.0


def _stacks(model, params):
    blocks, repeats = SMALL["blocks"], SMALL["repeats"]
    port_params = model.state_dict()
    return (
        tcn_cuda.stack_canonical(port_params, blocks=blocks, repeats=repeats),
        tcn_cuda.stack_tcn_weights(port_params, blocks=blocks, repeats=repeats),
        jtcn_train.stack_canonical(params, blocks=blocks, repeats=repeats),
        jtcn.stack_tcn_weights(params, blocks=blocks, repeats=repeats),
    )


@pytest.mark.parametrize("which", ["stack_canonical", "stack_tcn_weights"])
def test_stacks_match_jax(which):
    _, _, params, model, _ = _setup(16)
    canon, kernel, jcanon, jkernel = _stacks(model, params)
    got, want = (canon, jcanon) if which == "stack_canonical" else (kernel, jkernel)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        bf16 = w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if bf16:  # the same rounding of the same fp32 values
            np.testing.assert_array_equal(g, w)
        else:  # fp32 products and sums
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _trunk_inputs(k, seed=3):
    _, _, params, model, _ = _setup(16)
    h0 = np.random.default_rng(seed).standard_normal((2, k, SMALL["bottleneck"])).astype(np.float32)
    dils = tuple(2**x for _ in range(SMALL["repeats"]) for x in range(SMALL["blocks"]))
    return h0, dils, _stacks(model, params)


@pytest.mark.parametrize("k", [128, 130])
def test_trunk_plain_matches_pallas_interpret(k):
    h0, dils, (canon, kernel, jcanon, jkernel) = _trunk_inputs(k)
    want = np.asarray(
        jtcn.tcn_trunk_pallas(jnp.asarray(h0), *jkernel, dils=dils, interpret=True).astype(jnp.float32)
    )
    got = tcn_cuda.tcn_trunk_plain(torch.from_numpy(h0), *kernel, dils=dils)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, k, SMALL["bottleneck"])
    assert _snr_db(want, got.float().numpy()) >= TRUNK_DB
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(tcn_cuda.tcn_trunk_cuda(torch.from_numpy(h0), *kernel, dils=dils), got)


@pytest.mark.parametrize("k", [128, 130])
def test_trunk_reference_matches_jax_and_bounds_the_plain_trunk(k):
    h0, dils, (canon, kernel, jcanon, _) = _trunk_inputs(k)
    want = np.asarray(jtcn_train.trunk_reference(jnp.asarray(h0), *jcanon, dils=dils))
    ref = tcn_cuda.trunk_reference(torch.from_numpy(h0), *canon, dils=dils).numpy()
    assert _snr_db(want, ref) >= FP32_DB
    plain = tcn_cuda.tcn_trunk_plain(torch.from_numpy(h0), *kernel, dils=dils).float().numpy()
    assert _snr_db(ref, plain) >= BF16_PAIR_DB  # bf16 storage against the fp32 oracle


@pytest.mark.parametrize("win", [16, 32])
def test_cuda_apply_on_cpu_matches_pallas_apply(win):
    cfg, jmodel, params, model, mix = _setup(win)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    want = np.asarray(jserving.pallas_apply(params, jnp.asarray(mix), interpret=True, **cfg))
    got = cuda_apply(model, torch.from_numpy(mix)).numpy()
    assert got.shape == want.shape == ref.shape
    assert _snr_db(want, got) >= BF16_PAIR_DB
    assert _snr_db(ref, got) > PALLAS_DB
    with plain_versions():
        assert np.array_equal(cuda_apply(model, torch.from_numpy(mix)).numpy(), got)


def test_cuda_apply_ragged_frames():
    """K = 130 frames: no multiple of any tile; the plain trunk's taps and
    statistics see exactly the valid frames, as the Pallas kernel's masks do."""
    cfg, jmodel, params, model, _ = _setup(16)
    mix = (0.3 * np.random.default_rng(4).standard_normal((2, 1040))).astype(np.float32)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(mix)))
    got = cuda_apply(model, torch.from_numpy(mix)).numpy()
    assert got.shape == ref.shape == (2, 2, 1040)
    assert _snr_db(ref, got) > PALLAS_DB


@pytest.mark.parametrize("win,count", [(16, 2_226_092), (32, 2_234_284)])
def test_full_width_param_counts(win, count):
    model = ConvTasNet(win=win)
    assert sum(p.numel() for p in model.parameters()) == count
    names = {n for n, _ in model.named_parameters()}
    assert {"encoder.kernel", "tcn_2_6.depthwise.kernel", "decoder.kernel"} <= names
    assert tuple(model.decoder.kernel.shape) == (win, 256, 1)


def test_init_follows_flax():
    model = ConvTasNet(**SMALL, win=16, generator=torch.Generator().manual_seed(0))
    k = model.tcn_0_0.expand.kernel
    assert abs(k.std().item() - (1 / SMALL["bottleneck"]) ** 0.5) < 0.03  # lecun-normal
    assert k.abs().max().item() <= 2 * (1 / SMALL["bottleneck"]) ** 0.5 / 0.8796 + 1e-6
    assert torch.all(model.tcn_0_0.norm1.gamma == 1) and torch.all(model.tcn_0_0.expand.bias == 0)
    assert model.mask_prelu.alpha.tolist() == [0.25]
    same = ConvTasNet(**SMALL, win=16, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), same.parameters()))


def test_weight_bridge_round_trip():
    _, jmodel, params, model, mix = _setup(16)
    tree = convtasnet_params(model.state_dict())
    assert jax.tree.structure(tree) == jax.tree.structure(jax.tree.map(np.asarray, params))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = ConvTasNet(**SMALL, win=16)
    again.load_state_dict(convtasnet_state_dict({"params": tree}))
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), model.state_dict().values()))


def test_serving_paths_refuse_a_causal_model():
    _, _, _, model, mix = _setup(16, causal=True)
    for fn in (cuda_apply, fused_apply):
        with pytest.raises(ValueError, match="gLN topology"):
            fn(model, torch.from_numpy(mix))


@pytest.mark.parametrize(
    "change,error",
    [
        ("dilation", ValueError),
        ("blocks", ValueError),
        ("dtype", TypeError),
        ("shape", ValueError),
    ],
)
def test_trunk_raises_where_pallas_asserts(change, error):
    h0, dils, (_, kernel, _, _) = _trunk_inputs(128)
    we, wdw, wg, vecs = kernel
    h0 = torch.from_numpy(h0)
    if change == "dilation":  # blocks=8 would reach 2^7 = 128 > the 64-frame halo
        dils = dils[:-1] + (128,)
    elif change == "blocks":
        dils = dils[:-1]
    elif change == "dtype":
        we = we.float()
    else:
        wg = wg[:, :, :-1]
    for fn in (tcn_cuda.tcn_trunk_cuda, tcn_cuda.tcn_trunk_plain):
        with pytest.raises(error):
            fn(h0, we, wdw, wg, vecs, dils=dils)


def test_cuda_apply_refuses_dilation_past_the_halo():
    model = ConvTasNet(**dict(SMALL, blocks=8, repeats=1), win=16)
    with pytest.raises(ValueError, match="dilations"):
        cuda_apply(model, torch.zeros(1, 1024))


def test_module_rejects_unpadded_lengths():
    _, _, _, model, _ = _setup(16)
    with pytest.raises(ValueError, match="multiple of win//2"):
        model(torch.zeros(1, 1001))
