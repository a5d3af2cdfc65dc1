"""``cuda_apply``'s weight cache (``models/tasnet_serving.py::_serving``) on
the CPU, through the trunk's plain version: a call on unchanged parameters
reuses the operands built by the first, every way of changing a parameter
rebuilds them, the outputs are those of a model that has never been served,
bit for bit, and an entry lives no longer than its model."""

from __future__ import annotations

import gc
import weakref

import pytest
import torch

from speech_separation_tpu_torch.models import tasnet_serving as serving
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.ops import plain_versions

# small, gLN, every dilation path (up to 2^(blocks-1) = 4 on K = 100 frames)
SMALL = dict(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3, blocks=3,
             repeats=2)
SAMPLES = 800


def _model(seed: int = 0) -> ConvTasNet:
    """A small model with every parameter perturbed (init leaves gamma = 1
    and beta, biases = 0, which would leave the folds untested)."""
    model = ConvTasNet(**SMALL, generator=torch.Generator().manual_seed(seed)).eval()
    noise = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=noise))
    return model


def _fresh(model: ConvTasNet) -> ConvTasNet:
    """A model never served, with ``model``'s weights."""
    fresh = ConvTasNet(**SMALL).eval()
    fresh.load_state_dict(model.state_dict())
    return fresh


@pytest.fixture
def mix() -> torch.Tensor:
    return 0.3 * torch.randn((2, SAMPLES), generator=torch.Generator().manual_seed(1))


@pytest.fixture
def builds(monkeypatch) -> list:
    """Counts the trunk's weight stackings that ``cuda_apply`` asks for."""
    calls = []
    stack = serving.stack_tcn_weights

    def counted(*args, **kwargs):
        calls.append(1)
        return stack(*args, **kwargs)

    monkeypatch.setattr(serving, "stack_tcn_weights", counted)
    return calls


def _apply(model, mix):
    with plain_versions():
        return serving.cuda_apply(model, mix)


def test_a_second_call_is_a_hit(mix, builds):
    model = _model()
    first = _apply(model, mix)
    second = _apply(model, mix)
    assert len(builds) == 1
    assert torch.equal(first, second)


def test_outputs_equal_a_model_never_served(mix, builds):
    model = _model()
    _apply(model, mix)
    for _ in range(2):
        got = _apply(model, mix)
    assert torch.equal(got, _apply(_fresh(model), mix))
    assert len(builds) == 2  # the fresh model missed


def _add_in_place(model):
    with torch.no_grad():
        model.decoder.bias.add_(0.05)  # an optimizer's update


def _load_state_dict(model):
    model.load_state_dict(_model(seed=7).state_dict())


def _new_parameter(model):
    block = model.get_submodule("tcn_1_2.expand")
    block.kernel = torch.nn.Parameter(block.kernel.detach() * 1.5)


def _new_storage(model):
    model.input_norm.gamma.data = model.input_norm.gamma.data * 0.5


def _to_float64(model):
    model.double()  # the same values, served from new storage


def _dtype_round_trip(model):
    model.double().float()


@pytest.mark.parametrize("change", [_add_in_place, _load_state_dict, _new_parameter, _new_storage,
                                    _to_float64, _dtype_round_trip])
def test_a_changed_parameter_rebuilds(mix, builds, change):
    model = _model()
    before = _apply(model, mix)
    change(model)
    after = _apply(model, mix)
    assert len(builds) == 2
    assert torch.equal(after, before) == (change in (_to_float64, _dtype_round_trip))
    assert torch.equal(after, _apply(_fresh(model), mix))
    _apply(model, mix)
    assert len(builds) == 3  # the fresh model's one build, then a hit again


def test_grad_modes_share_an_entry(mix, builds):
    model = _model()
    with torch.inference_mode():
        first = _apply(model, mix)
    with torch.no_grad():
        second = _apply(model, mix)
    third = _apply(model, mix)
    with torch.inference_mode():
        fourth = _apply(model, mix)
    assert len(builds) == 1
    for out in (second, third, fourth):
        assert torch.equal(out, first)


def test_parameters_made_in_inference_mode_build_every_call(mix, builds):
    """Inference tensors keep no version counter: nothing to validate an
    entry by, so nothing is cached."""
    model = _model()
    with torch.inference_mode():
        served = _fresh(model)
        outs = [_apply(served, mix) for _ in range(2)]
    assert len(builds) == 2 and served not in serving._SERVING
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], _apply(model, mix))


def test_two_models_keep_their_own_entries(mix, builds):
    a, b = _model(seed=0), _model(seed=1)
    out_a, out_b = _apply(a, mix), _apply(b, mix)
    assert torch.equal(_apply(a, mix), out_a) and torch.equal(_apply(b, mix), out_b)
    assert not torch.equal(out_a, out_b)
    assert len(builds) == 2
    assert serving._SERVING[a][1] is not serving._SERVING[b][1]


def test_an_entry_dies_with_its_model(mix):
    model = _model()
    _apply(model, mix)
    stacks = weakref.ref(serving._SERVING[model][1].stacks[0])
    entries = len(serving._SERVING)
    del model
    gc.collect()
    assert stacks() is None
    assert len(serving._SERVING) <= entries - 1


def test_an_entry_holds_the_storage_its_key_names(mix):
    """While the entry stands no other tensor can take a keyed address, even
    where the fp32 parameter dict holds copies (a float64 model)."""
    model = _model().double()
    _apply(model, mix)
    key, _, held = serving._SERVING[model]
    assert [k[0] for k in key] == [t.data_ptr() for t in held]
