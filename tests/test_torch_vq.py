"""PyTorch port, the nearest-codebook search and the quantizers against the JAX
reference on the CPU: the ``nearest_code`` kernel's plain version (the
wrapper's CPU path) against brute force, JAX's XLA ``nearest_code_indices``
and ``nearest_code_pallas`` in interpret mode; ``VectorQuantizer``,
``ResidualVectorQuantizer`` and ``gumbel_softmax`` against flax, gradients
included; ``nadam`` against optax; ``summed_squared_error``.

Inputs are made with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from speech_separation_tpu.losses import summed_squared_error as jax_sse
from speech_separation_tpu.models import vq as jvq
from speech_separation_tpu.ops.vq_pallas import nearest_code_pallas
from speech_separation_tpu.train import nadam as jax_nadam
from speech_separation_tpu_torch import train
from speech_separation_tpu_torch.losses import summed_squared_error
from speech_separation_tpu_torch.models.vq import (
    GumbelSoftmax,
    ResidualVectorQuantizer,
    VectorQuantizer,
    gumbel_softmax,
    nearest_code_indices,
)
from speech_separation_tpu_torch.ops.vq_cuda import nearest_code, nearest_code_plain

# fp32 against fp32 (sums in another order, JAX adds ‖x‖²): 1e-6 relative on
# outputs and losses, 1e-5 on gradients, which sum over every row
RTOL, GRAD_RTOL = 1e-6, 1e-5
ATOL = 1e-7
# A pick that differs from JAX's on random fp32 inputs must be a near tie: the
# two codes' float64 squared distances within 1e-5 of ‖x‖² + ‖e‖² (fp32 dot
# products of <= 64 terms, rounded in another order on each side).
NEAR_TIE_REL = 1e-5
OPTIM_RTOL = 1e-6  # fp32 NAdam, bias corrections in float32 on both sides


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _dyadic(shape, seed):
    """Multiples of 1/32 in [-1, 1]: every product and partial sum of a score
    over D <= 64 is exact in fp32, in any order, so every side computes the
    same scores and only the argmin rule can differ."""
    return (np.random.default_rng(seed).integers(-32, 33, shape) / 32).astype(np.float32)


def _brute_force(flat, codebook):
    dist = ((flat[:, :, None].astype(np.float64) - codebook[None].astype(np.float64)) ** 2).sum(1)
    return np.argmin(dist, axis=1), dist


def _assert_near_ties(flat, codebook, got, want):
    """``got`` equals ``want`` except at near ties (float64 distances)."""
    _, dist = _brute_force(flat, codebook)
    rows = np.nonzero(got != want)[0]
    scale = (flat.astype(np.float64) ** 2).sum(1) + (codebook.astype(np.float64) ** 2).sum(0).max()
    gaps = np.abs(dist[rows, got[rows]] - dist[rows, want[rows]]) / scale[rows]
    assert np.all(gaps <= NEAR_TIE_REL), (rows, gaps)
    return rows


@pytest.mark.parametrize("n,d,k", [(256, 64, 512), (300, 48, 200), (37, 13, 65), (129, 16, 509)])
def test_nearest_code_plain_matches_every_reference_exactly(n, d, k):
    flat, codebook = _dyadic((n, d), 1), _dyadic((d, k), 2)
    want, dist = _brute_force(flat, codebook)
    ordered = np.sort(dist, axis=1)
    assert np.all(ordered[:, 1] > ordered[:, 0])  # tie-free: a unique nearest code per row
    got = nearest_code_plain(torch.from_numpy(flat), torch.from_numpy(codebook))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    xla = jvq.nearest_code_indices(jnp.asarray(flat), jnp.asarray(codebook))
    pallas = nearest_code_pallas(jnp.asarray(flat), jnp.asarray(codebook))
    np.testing.assert_array_equal(np.asarray(xla), want)
    np.testing.assert_array_equal(np.asarray(pallas), want)


def test_nearest_code_exact_ties_pick_the_lowest_index():
    codebook = _dyadic((16, 40), 3)
    codebook = np.concatenate([codebook, codebook, codebook[:, :5]], axis=1)  # 85 codes
    flat = np.concatenate([codebook[:, [3, 7, 45, 60, 82]].T, _dyadic((20, 16), 4)])
    got = nearest_code_plain(torch.from_numpy(flat), torch.from_numpy(codebook)).numpy()
    want, _ = _brute_force(flat, codebook)  # np.argmin takes the first of equal values
    np.testing.assert_array_equal(got[:5], [3, 7, 5, 20, 2])
    np.testing.assert_array_equal(got, want)
    for jax_fn in (jvq.nearest_code_indices, nearest_code_pallas):
        np.testing.assert_array_equal(np.asarray(jax_fn(jnp.asarray(flat), jnp.asarray(codebook))), got)


def test_nearest_code_on_random_fp32_inputs_differs_from_jax_only_at_near_ties():
    flat, codebook = _normal((4000, 64), 5), _normal((64, 512), 6)
    got = nearest_code_plain(torch.from_numpy(flat), torch.from_numpy(codebook)).numpy()
    want = np.asarray(jvq.nearest_code_indices(jnp.asarray(flat), jnp.asarray(codebook)))
    rows = _assert_near_ties(flat, codebook, got, want)
    assert len(rows) <= 4  # 0.1%


def test_nearest_code_wrapper_takes_the_plain_version_only_on_the_cpu():
    flat, codebook = _normal((50, 16), 7), _normal((16, 33), 8)
    before = nearest_code.launches
    got = nearest_code(torch.from_numpy(flat), torch.from_numpy(codebook))
    assert nearest_code.launches == before  # no kernel ran
    np.testing.assert_array_equal(got.numpy(), _brute_force(flat, codebook)[0])
    meta = torch.empty(50, 16, device="meta"), torch.empty(16, 33, device="meta")
    with pytest.raises(ValueError, match="unsupported devices"):
        nearest_code(*meta)
    # the layer's route: non-contiguous sub-vectors are made contiguous first
    wide = torch.from_numpy(_normal((50, 32), 9))
    np.testing.assert_array_equal(
        nearest_code_indices(wide[:, 16:], torch.from_numpy(codebook)).numpy(),
        _brute_force(wide[:, 16:].numpy(), codebook)[0],
    )


def _vq_pair(seed, shape, **kw):
    x = _normal(shape, seed)
    jmodule = jvq.VectorQuantizer(**kw)
    params = jax.tree.map(np.asarray, jmodule.init(jax.random.key(seed), jnp.asarray(x))["params"])
    module = VectorQuantizer(**kw)
    with torch.no_grad():
        module.embeddings.copy_(torch.from_numpy(np.array(params["embeddings"])))
    return x, jmodule, params, module


def _grads_jax(jmodule, params, x, w):
    def loss(p, x):
        out, aux = jmodule.apply({"params": p}, x)
        return jnp.sum(out * w) + 3.0 * aux

    return jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))


def _grads_port(module, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = module(xt)
    (torch.sum(out * torch.from_numpy(w)) + 3.0 * aux).backward()
    return module.embeddings.grad.numpy(), xt.grad.numpy(), out.detach().numpy(), aux.item()


def test_vector_quantizer_matches_jax():
    x, jmodule, params, module = _vq_pair(
        10, (2, 25, 16), num_embeddings=32, embedding_dim=16, init_scale=1.0
    )
    w = _normal(x.shape, 11)
    jout, jaux = jmodule.apply({"params": params}, jnp.asarray(x))
    g_cb, g_x, out, aux = _grads_port(module, x, w)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, float(jaux), rtol=RTOL)
    jg_p, jg_x = _grads_jax(jmodule, params, x, w)
    np.testing.assert_allclose(g_cb, np.asarray(jg_p["embeddings"]), rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(g_x, np.asarray(jg_x), rtol=GRAD_RTOL, atol=1e-6)
    # straight-through: d(sum(q * w))/dx is w
    x2 = torch.from_numpy(x).requires_grad_()
    torch.sum(module(x2)[0] * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(x2.grad.numpy(), w, atol=1e-6)
    # the lookup is codebook.T[indices]
    idx = np.asarray([[0, 31, 5], [7, 7, 2]], np.int32)
    np.testing.assert_array_equal(
        VectorQuantizer.lookup(module.embeddings, torch.from_numpy(idx)).detach().numpy(),
        np.asarray(jvq.VectorQuantizer.lookup(jnp.asarray(params["embeddings"]), jnp.asarray(idx))),
    )


@pytest.mark.parametrize("pq", [1, 2, 4])
def test_residual_vector_quantizer_matches_jax(pq):
    kw = dict(num_embeddings=24, embedding_dim=16, depth=2, pq=pq)
    x = _normal((3, 20, 16), 20 + pq, 0.6)
    w = _normal(x.shape, 30 + pq)
    jmodule = jvq.ResidualVectorQuantizer(**kw)
    params = jax.tree.map(np.asarray, jmodule.init(jax.random.key(pq), jnp.asarray(x))["params"])
    module = ResidualVectorQuantizer(**kw)
    assert tuple(module.embeddings.shape) == params["embeddings"].shape == (2, pq, 16 // pq, 24)
    with torch.no_grad():
        module.embeddings.copy_(torch.from_numpy(np.array(params["embeddings"])))

    jout, jaux = jmodule.apply({"params": params}, jnp.asarray(x))
    g_cb, g_x, out, aux = _grads_port(module, x, w)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, float(jaux), rtol=RTOL)
    jg_p, jg_x = _grads_jax(jmodule, params, x, w)
    np.testing.assert_allclose(g_cb, np.asarray(jg_p["embeddings"]), rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(g_x, np.asarray(jg_x), rtol=GRAD_RTOL, atol=1e-6)

    with torch.no_grad():
        codes = module.codes(torch.from_numpy(x))
    jcodes = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x), method="codes"))
    assert codes.shape == jcodes.shape == (3, 20, 2 * pq) and codes.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    got = ResidualVectorQuantizer.lookup(module.embeddings, codes).detach().numpy()
    want = jvq.ResidualVectorQuantizer.lookup(jnp.asarray(params["embeddings"]), jnp.asarray(jcodes))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    # the cascade: the lookup of every stage's codes is the forward's output
    np.testing.assert_allclose(got, out, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_matches_jax_on_the_same_draws(hard):
    logits = _normal((4, 6, 10), 40)
    key = jax.random.key(41)
    want = jvq.gumbel_softmax(jnp.asarray(logits), key, temperature=0.7, hard=hard)
    uniform = np.asarray(jax.random.uniform(key, logits.shape))  # JAX's own draws
    lt = torch.from_numpy(logits).requires_grad_()
    got = gumbel_softmax(lt, temperature=0.7, hard=hard, uniform=torch.from_numpy(uniform.copy()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    w = _normal(logits.shape, 42)
    (got * torch.from_numpy(w)).sum().backward()
    jgrad = jax.grad(lambda l: jnp.sum(jvq.gumbel_softmax(l, key, 0.7, hard) * w))(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)


def test_gumbel_softmax_deterministic_and_sampled_paths():
    layer = GumbelSoftmax(hard=True)
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0]])
    # deterministic: multi-hot on exact ties, as the JAX layer writes it
    np.testing.assert_array_equal(layer(logits, deterministic=True).numpy(), [[0, 1, 1, 0]])
    # sampled: the high-logit classes dominate, the draws come from the generator
    gen = torch.Generator().manual_seed(0)
    counts = sum(layer(torch.tensor([[0.0, 2.0, 0.0, 0.0]]), generator=gen) for _ in range(200))
    assert counts.sum().item() == pytest.approx(200) and counts[0, 1].item() > 100
    again = torch.Generator().manual_seed(0)
    first = layer(torch.tensor([[0.0, 2.0, 0.0, 0.0]]), generator=again)
    assert torch.equal(first, layer(torch.tensor([[0.0, 2.0, 0.0, 0.0]]),
                                    generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_nadam_matches_optax(clip):
    shapes = {"w": (7, 5), "b": (5,), "u": (3, 4, 2)}
    params = {k: _normal(s, i) for i, (k, s) in enumerate(shapes.items())}
    tx = jax_nadam(2e-3, grad_clip_norm=clip)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = train.nadam(2e-3, grad_clip_norm=clip)(tparams.values())
    for step in range(25):
        scale = 0.05 if step != 7 else 5.0  # step 7's global norm is far above the clip
        grads = {k: _normal(s, 100 + step * 3 + i, scale) for i, (k, s) in enumerate(shapes.items())}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=OPTIM_RTOL, err_msg=f"clip {clip} step {step} {k}")
    assert opt.param_groups[0]["count"] == 25


def test_summed_squared_error_matches_jax():
    preds, targets = _normal((3, 50, 2), 50), _normal((3, 50, 2), 51)
    got = summed_squared_error(torch.from_numpy(preds), torch.from_numpy(targets)).item()
    np.testing.assert_allclose(got, float(jax_sse(jnp.asarray(preds), jnp.asarray(targets))),
                               rtol=RTOL)
