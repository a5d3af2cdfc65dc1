"""PyTorch port, the kernel-or-plain choice on the CPU: which recurrence
``models/blstm.py::BiLSTM`` reaches with gradients on or off and with or
without packed rows, the scoped ``ops.plain_versions()`` switch that
every CUDA wrapper reads through ``ops.dispatch.use_plain``, and the scoped
``ops.fixed_shape_calls()`` hint a streaming engine gives the serving paths."""

from __future__ import annotations

import threading

import pytest
import torch

from speech_separation_tpu_torch import ops
from speech_separation_tpu_torch.models import blstm
from speech_separation_tpu_torch.models.blstm import BiLSTM
from speech_separation_tpu_torch.ops import fixed_shape_calls, plain_versions, use_plain
from speech_separation_tpu_torch.ops.dispatch import in_fixed_shape_calls


@pytest.mark.parametrize("packed", [False, True], ids=["rows", "packed"])
@pytest.mark.parametrize("grad", [True, False], ids=["grad", "no_grad"])
def test_bilstm_reaches_one_recurrence(monkeypatch, grad, packed):
    calls = {"bilstm_train": 0, "lstm_recurrence": 0, "lstm_train_forward": 0}
    for name in calls:
        def counting(*args, _run=getattr(blstm, name), _name=name, **kwargs):
            calls[_name] += 1
            return _run(*args, **kwargs)

        monkeypatch.setattr(blstm, name, counting)
    layer = BiLSTM(5, 6, generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 9, 5, generator=torch.Generator().manual_seed(1))
    seg = torch.tensor([[0] * 4 + [1] * 5] * 3) if packed else None
    with torch.set_grad_enabled(grad):
        y = layer(x, seg)
    want = "bilstm_train" if grad else ("lstm_train_forward" if packed else "lstm_recurrence")
    assert calls == {name: int(name == want) for name in calls}
    assert y.shape == (3, 9, 12) and (y.grad_fn is not None) == grad
    if grad:
        y.sum().backward()
        assert all(p.grad is not None for p in layer.parameters())


def test_the_switch_is_off_by_default_nests_and_restores():
    cpu, meta = torch.zeros(1), torch.zeros(1, device="meta")
    assert ops.plain_versions is plain_versions
    assert use_plain(cpu) and not use_plain(meta)  # a CPU tensor is always plain
    with plain_versions():
        assert use_plain(meta)
        with plain_versions(False):
            assert not use_plain(meta) and use_plain(cpu)
        assert use_plain(meta)
    assert not use_plain(meta)


def test_the_switch_is_restored_after_an_exception():
    meta = torch.zeros(1, device="meta")
    with pytest.raises(RuntimeError, match="inside"):
        with plain_versions():
            with plain_versions():
                raise RuntimeError("inside")
    assert not use_plain(meta)


def test_the_switch_stays_in_its_own_thread():
    meta = torch.zeros(1, device="meta")
    seen = []
    with plain_versions():
        worker = threading.Thread(target=lambda: seen.append(use_plain(meta)))
        worker.start()
        worker.join()
        seen.append(use_plain(meta))
    assert seen == [False, True]


def test_the_fixed_shape_hint_is_off_by_default_nests_and_restores():
    assert ops.fixed_shape_calls is fixed_shape_calls and not in_fixed_shape_calls()
    with pytest.raises(RuntimeError, match="inside"):
        with fixed_shape_calls():
            with fixed_shape_calls():
                assert in_fixed_shape_calls()
            assert in_fixed_shape_calls()
            raise RuntimeError("inside")
    assert not in_fixed_shape_calls()
    seen = []
    with fixed_shape_calls():
        thread = threading.Thread(target=lambda: seen.append(in_fixed_shape_calls()))
        thread.start()
        thread.join()
    assert seen == [False]  # another thread's calls are not declared
