"""PyTorch port, uPIT BLSTM separator against the JAX reference on the CPU.

JAX weights cross to the port through ``weights.upit_blstm_state_dict``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speech_separation_tpu.models import UPitBlstm as JaxUPitBlstm
from speech_separation_tpu.models.upit import upit_blstm_pallas_forward
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.weights import upit_blstm_state_dict

ATOL = 1e-5  # fp32 end to end, the JAX upit_blstm_pallas_forward test's bound
SMALL = dict(input_size=9, output_size=9, hidden=8, num_layers=2)


@pytest.fixture(scope="module")
def small():
    x = np.random.default_rng(1).standard_normal((2, 21, 9)).astype(np.float32)
    jmodel = JaxUPitBlstm(**SMALL)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    model = UPitBlstm(**SMALL).eval()
    model.load_state_dict(upit_blstm_state_dict(jax.tree.map(np.asarray, params)))
    return x, jmodel, params, model


def test_matches_jax_apply(small):
    x, jmodel, params, model = small
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), deterministic=True))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 21, 18)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_matches_jax_pallas_forward(small):
    x, _, params, model = small
    want = np.asarray(
        upit_blstm_pallas_forward(
            params, jnp.asarray(x), num_layers=2, compute_dtype=jnp.float32, tile_t=8,
            interpret=True,
        )
    )
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_state_dict_is_a_rename_of_the_jax_tree(small):
    _, _, params, model = small
    converted = upit_blstm_state_dict({"params": jax.tree.map(np.asarray, params)})
    assert set(converted) == set(model.state_dict())
    assert tuple(converted["bilstm_1.cells.kernel"].shape) == (2, 16, 32)
    assert tuple(converted["heads.mask_head_1.kernel"].shape) == (16, 9)
    np.testing.assert_array_equal(
        converted["bilstm_0.cells.recurrent_kernel"].numpy(),
        np.asarray(params["bilstm_0"]["cells"]["recurrent_kernel"]),
    )


def test_full_width_param_count_matches_jax():
    model = UPitBlstm(generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in model.parameters()) == 16_077_602
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["bilstm_0.cells.kernel"] == (2, 496, 1984)
    assert shapes["bilstm_2.cells.recurrent_kernel"] == (2, 496, 1984)
    assert shapes["input_proj.kernel"] == (129, 496)


def test_generator_seed_is_deterministic():
    a = UPitBlstm(**SMALL, generator=torch.Generator().manual_seed(3)).state_dict()
    b = UPitBlstm(**SMALL, generator=torch.Generator().manual_seed(3)).state_dict()
    c = UPitBlstm(**SMALL, generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bilstm_0.cells.kernel"], c["bilstm_0.cells.kernel"])


def test_bf16_copy_runs_in_bf16(small):
    x, _, _, model = small
    with torch.no_grad():
        want = model(torch.from_numpy(x))
        got = copy.deepcopy(model).to(torch.bfloat16)(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    # bf16 weights and activations, fp32 recurrence carry
    assert (got.float() - want).abs().max().item() <= 5e-2
