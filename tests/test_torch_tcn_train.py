"""PyTorch port, the Conv-TasNet trunk for training against the JAX reference on
the CPU: ``ops/tcn_train_cuda.py`` (whose wrappers take their plain versions
for a CPU tensor) against ``ops/tcn_train_pallas.py``.

Inputs are made with numpy from a seed and handed to both sides. In fp32
storage the plain passes compute the same function as ``trunk_reference``,
so their gradients are held to JAX autodiff of it at the JAX test's own
60 dB. In bf16 the port and ``tcn_trunk_train(interpret=True)`` round at
different places in the forward (the port folds gamma2 into the res|skip
product once, as the serving kernel does; the TPU forward folds gamma2 /
sigma2 per item), and each lands 16 to 24 dB from the other and from the
fp32 reference on these inputs (the TPU's own bf16 test measures 18 to 21
dB against the reference): bounds below.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import ConvTasNet as JaxConvTasNet
from speech_separation_tpu.ops import tcn_train_pallas as jtrain
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.ops import plain_versions, tcn_cuda
from speech_separation_tpu_torch.ops.tcn_train_cuda import (
    tcn_train_backward,
    tcn_train_backward_plain,
    tcn_train_forward,
    tcn_train_forward_plain,
    tcn_trunk_train,
)
from speech_separation_tpu_torch.weights import convtasnet_state_dict

CB, CH, TAPS = 16, 32, 3
DILS = (1, 2, 4, 1, 2, 4)  # 2 x 3 blocks
EXACT_DB = 60.0  # fp32 storage against JAX autodiff (measured ~121 to 127 dB)
PRIMAL_FP32_DB = 90.0  # fp32 storage forward against trunk_reference (measured ~124 dB)
# bf16 against tcn_trunk_train(interpret=True), measured at K = 130: primal
# 40.4 dB; dh0 18.9, dwe 18.3, dwdw 17.7, dwcat 19.5, dvec rows 0-6 16.0,
# alpha lane-sums 15.9 and 23.6 dB
BF16_PRIMAL_DB = 34.0
BF16_GRAD_DB = 12.0


def _snr_db(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.square(ref).sum() / max(np.square(ref - est).sum(), 1e-30))


def _inputs(b, k, seed=0):
    rng = np.random.default_rng(seed)
    n, vdim = len(DILS), max(CH, 2 * CB)
    vecs = (rng.standard_normal((n, 10, vdim)) * 0.1).astype(np.float32)
    vecs[:, 1] += 1.0  # gammas near 1
    vecs[:, 4] += 1.0
    vecs[:, 7] = 0.0
    vecs[:, 8] = (0.25 + 0.01 * np.arange(n))[:, None]  # PReLU slopes, broadcast
    vecs[:, 9] = (0.2 - 0.015 * np.arange(n))[:, None]
    arrays = [
        (rng.standard_normal((b, k, CB)) * 0.5).astype(np.float32),
        (rng.standard_normal((n, CB, CH)) * 0.3).astype(np.float32),
        (rng.standard_normal((n, TAPS, CH)) * 0.3).astype(np.float32),
        (rng.standard_normal((n, CH, 2 * CB)) * 0.3).astype(np.float32),
        vecs,
    ]
    probe = rng.standard_normal((b, k, CB)).astype(np.float32)
    return arrays, probe


def _jax_grads(fn, arrays, probe):
    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * probe)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, arrays))


def _port(arrays, probe, storage):
    params = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    # fp32 storage is the plain passes' alone; bf16 takes the kernels' wrappers,
    # which on a CPU tensor run their plain versions
    with plain_versions(storage != torch.bfloat16):
        out = tcn_trunk_train(*params, dils=DILS, taps=TAPS, storage=storage)
        (out.float() * torch.from_numpy(probe)).sum().backward()
    return out.detach().float().numpy(), [p.grad.numpy() for p in params]


def _views(grads):
    """dh0, dwe, dwdw, dwcat, dvec rows 0-6, and the PReLU rows summed over
    lanes (what reaches the scalar slope through stack_canonical)."""
    g = [np.asarray(x) for x in grads]
    return {
        "dh0": g[0], "dwe": g[1], "dwdw": g[2], "dwcat": g[3], "dvec": g[4][:, :7],
        "dalpha": g[4][:, 8:10].sum(-1),
    }


@pytest.mark.parametrize("b,k", [(2, 130), (1, 400)])
def test_fp32_storage_grads_match_jax_autodiff(b, k):
    arrays, probe = _inputs(b, k)
    want = _views(_jax_grads(lambda *a: jtrain.trunk_reference(*a, dils=DILS, taps=TAPS), arrays, probe))
    out, grads = _port(arrays, probe, torch.float32)
    ref = np.asarray(jtrain.trunk_reference(*map(jnp.asarray, arrays), dils=DILS, taps=TAPS))
    assert out.shape == ref.shape == (b, k, CB)
    assert _snr_db(ref, out) >= PRIMAL_FP32_DB
    for name, got in _views(grads).items():
        assert got.shape == want[name].shape, name
        assert _snr_db(want[name], got) >= EXACT_DB, (name, _snr_db(want[name], got))


@functools.lru_cache(maxsize=None)
def _bf16_pair():
    arrays, probe = _inputs(2, 130)
    fn = functools.partial(jtrain.tcn_trunk_train, dils=DILS, taps=TAPS, chunk=512, interpret=True)
    want_out = np.asarray(fn(*map(jnp.asarray, arrays)).astype(jnp.float32))
    want = _views(_jax_grads(fn, arrays, probe))
    want["primal"] = want_out
    got_out, grads = _port(arrays, probe, torch.bfloat16)
    got = _views(grads)
    got["primal"] = got_out
    return want, got


@pytest.mark.parametrize("name", ["primal", "dh0", "dwe", "dwdw", "dwcat", "dvec", "dalpha"])
def test_bf16_trunk_matches_jax_pallas_interpret(name):
    want, got = _bf16_pair()
    bound = BF16_PRIMAL_DB if name == "primal" else BF16_GRAD_DB
    assert got[name].shape == want[name].shape
    assert _snr_db(want[name], got[name]) >= bound, _snr_db(want[name], got[name])


def test_forward_residuals_and_the_serving_trunk():
    arrays, _ = _inputs(2, 130, seed=1)
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    folded = tcn_cuda.fold_canonical(*canon)
    skip, hb, st = tcn_train_forward(h0, *folded, dils=DILS, taps=TAPS)
    # the wrapper takes the plain version for a CPU tensor; skip is the serving trunk's
    assert torch.equal(skip, tcn_train_forward_plain(h0, *folded, dils=DILS, taps=TAPS)[0])
    assert torch.equal(skip, tcn_cuda.tcn_trunk_plain(h0, *folded, dils=DILS, taps=TAPS))
    assert hb.shape == (len(DILS), 2, 130, CB) and hb.dtype == torch.bfloat16
    assert st.shape == (len(DILS), 2, 4) and st.dtype == torch.float32
    assert torch.equal(hb[0], h0.to(torch.bfloat16))
    # block 1's input is block 0's output: rerun the first block alone
    first = tcn_cuda.trunk_forward_plain(h0, *(t[:1] for t in folded), dils=DILS[:1], taps=TAPS,
                                         residuals=True)
    assert torch.equal(first[2][0], st[0])
    # st holds (mu1, 1/sigma1, mu2, 1/sigma2): the first block's t1 statistics
    v = folded[3][0]
    y = h0.to(torch.bfloat16).float() @ folded[0][0].float() + v[0, :CH]
    t1 = torch.where(y >= 0, y, v[6, :CH] * y)
    np.testing.assert_allclose(st[0, :, 0].numpy(), t1.mean(dim=(1, 2)).numpy(), rtol=1e-5)
    np.testing.assert_allclose(st[0, :, 1].numpy(), (1 / t1.std(dim=(1, 2), unbiased=False)).numpy(),
                               rtol=1e-4)


def test_backward_wrapper_takes_the_plain_version_on_cpu():
    arrays, probe = _inputs(2, 130, seed=2)
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    _, hb, st = tcn_train_forward(h0, *tcn_cuda.fold_canonical(*canon), dils=DILS, taps=TAPS)
    dskip = torch.from_numpy(probe)
    got = tcn_train_backward(dskip, hb, st, *canon, dils=DILS, taps=TAPS)
    want = tcn_train_backward_plain(dskip, hb, st, *canon, dils=DILS, taps=TAPS)
    shapes = [(2, 130, CB), (6, CB, CH), (6, TAPS, CH), (6, CH, 2 * CB), (6, 10, 2 * CB)]
    for g, w, shape in zip(got, want, shapes):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        assert torch.equal(g, w)
    assert torch.count_nonzero(got[4][:, 7]) == 0  # the spare row gets nothing


@pytest.mark.parametrize("change", ["dskip", "st", "wcat", "vecs", "dils"])
def test_backward_rejects_mismatched_shapes(change):
    arrays, probe = _inputs(1, 70, seed=3)
    h0, *canon = (torch.from_numpy(a) for a in arrays)
    _, hb, st = tcn_train_forward(h0, *tcn_cuda.fold_canonical(*canon), dils=DILS, taps=TAPS)
    dskip, dils = torch.from_numpy(probe), DILS
    we, wdw, wcat, vecs = canon
    if change == "dskip":
        dskip = dskip[:, :-1]
    elif change == "st":
        st = st[:, :, :2]
    elif change == "wcat":
        wcat = wcat[:, :, :-1]
    elif change == "vecs":
        vecs = vecs[:, :8]
    else:
        dils = DILS[:-1]
    with pytest.raises(ValueError, match=change if change != "dils" else "dilations"):
        tcn_train_backward(dskip, hb, st, we, wdw, wcat, vecs, dils=dils, taps=TAPS)


def test_grads_reach_the_convtasnet_parameters():
    """Through stack_canonical the trunk's gradients land on the module's
    parameters, the PReLU slopes' lanes summed: against jax.grad through the
    JAX stack_canonical and trunk_reference, fp32 storage."""
    cfg = dict(num_speakers=2, enc_dim=16, win=16, bottleneck=8, hidden=16, kernel=3, blocks=2,
               repeats=1)
    jmodel = JaxConvTasNet(**cfg)
    rng = np.random.default_rng(4)
    params = jmodel.init(jax.random.key(1), jnp.zeros((1, 640)))["params"]
    params = jax.tree.map(lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
                          params)
    h0 = rng.standard_normal((1, 80, cfg["bottleneck"])).astype(np.float32)
    dils = (1, 2)

    def loss(p):
        arrs = jtrain.stack_canonical(p, blocks=2, repeats=1)
        return jnp.sum(jtrain.trunk_reference(jnp.asarray(h0), *arrs, dils=dils) ** 2)

    want = convtasnet_state_dict(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    model = ConvTasNet(**cfg)
    model.load_state_dict(convtasnet_state_dict(params))
    named = dict(model.named_parameters())
    arrs = tcn_cuda.stack_canonical(named, blocks=2, repeats=1)
    with plain_versions():
        out = tcn_trunk_train(torch.from_numpy(h0), *arrs, dils=dils, storage=torch.float32)
        (out.float() ** 2).sum().backward()
    checked = 0
    for name, p in named.items():
        if not name.startswith("tcn_"):
            assert p.grad is None, name
            continue
        if not want[name].any():  # the last block's residual output feeds nothing
            assert not p.grad.any(), name
        else:
            assert _snr_db(want[name].numpy(), p.grad.numpy()) >= EXACT_DB, name
        checked += 1
    assert checked == 2 * 14  # 14 parameter tensors per block
