"""The port's profiler spans (``utils/profiling.py::span``) on the CPU: each
span recorded once where its work happens, nested and ordered as the trace
readers assume, host side only (no user annotation, so no GPU mirror on
CUDA), nothing built with the profiler off, and the outputs unchanged. The
device spans' timing events, which need CUDA, are stood in for by a fake
event class on the CPU."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speech_separation_tpu_torch import train
from speech_separation_tpu_torch.data.datasets import prefetch_to_device
from speech_separation_tpu_torch.models.dprnn import DPRNN
from speech_separation_tpu_torch.models.sepformer import SepFormer
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply
from speech_separation_tpu_torch.models.tfgridnet import TFGridNet
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.models.vqvae import VqVaeCodebook
from speech_separation_tpu_torch.ops import plain_versions
from speech_separation_tpu_torch.separate.streaming import StreamingSeparator
from speech_separation_tpu_torch.utils import profiling, span

TINY_TASNET = dict(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3,
                   blocks=3, repeats=2)
HOP, CONTEXT, SR = 400, 800, 8000  # a window of 1,200 samples, a multiple of win // 2
PUSHES = 3
STEPS = 2
ADAM = "Optimizer.step#Adam.step"  # torch's own span around the optimizer's update


def _events(prof) -> list:
    """The capture's raw host events (as the benchmark's trace reader takes them)."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def _spans(prof, name: str) -> list[tuple[int, int]]:
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in _events(prof)
                  if e.name() == name)


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _overlap(a, b) -> bool:
    return a[0] < b[1] and b[0] < a[1]


class _Counting:
    """A stand-in for the profiler's span primitive that counts its builds."""

    built: list[str] = []

    def __init__(self, name: str):
        type(self).built.append(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_span_builds_nothing_with_the_profiler_off(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "built", [])
    assert not torch.autograd._profiler_enabled()
    with span("stream.apply"), span("train.forward"):
        pass
    assert span("a") is span("b")  # one shared no-op context
    assert _Counting.built == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("stream.apply"):
            pass
    assert _Counting.built == ["sst.stream.apply"]  # the stand-in is the one span uses


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: ``record`` reads the test's clock
    (``now``, in ms) and notes the stream, and ``elapsed_time`` needs the end
    event synchronised."""

    now = 0.0

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        self.at = None
        self.streams = []
        self.synced = False

    def record(self, stream=None):
        self.at = type(self).now
        self.streams.append(stream)

    def synchronize(self):
        self.synced = True

    def elapsed_time(self, end: "_FakeEvent") -> float:
        assert self.at is not None and end.synced
        return end.at - self.at


STREAM = "the current stream"


class _NoEvent:
    def __init__(self, *args, **kwargs):
        raise AssertionError("a CUDA event was built")


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA initialised and not capturing, its events the fake's; the device
    spans cleared before and after."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: STREAM)
    monkeypatch.setattr(_FakeEvent, "now", 0.0)
    profiling.clear_device_spans()
    yield
    profiling.clear_device_spans()


def _device_names() -> list[str]:
    return [name for name, _, _ in profiling._DEVICE_SPANS]


def test_device_span_builds_nothing_with_the_profiler_off(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "built", [])
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    profiling.clear_device_spans()
    assert not torch.autograd._profiler_enabled()
    assert span("a", device=True) is span("b") is profiling._OFF  # the shared no-op
    with span("stream.fetch", device=True), span("train.backward", device=True):
        pass
    assert _Counting.built == [] and profiling._DEVICE_SPANS == []
    assert profiling.device_ms("sst.stream.fetch") == []


def test_device_spans_record_pairs_in_order(fake_cuda):
    clock = _FakeEvent
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer", device=True):
            clock.now = 1.0
            with span("inner", device=True):
                clock.now = 3.0
            clock.now = 6.0
            with span("inner", device=True):
                assert profiling.device_ms("sst.inner") == [2.0]  # the open one left out
                clock.now = 10.0
            with span("host"):  # no device argument: the host event alone
                clock.now = 12.0
            clock.now = 15.0
    assert _device_names() == ["sst.outer", "sst.inner", "sst.inner"]  # in the order opened
    assert profiling.device_ms("sst.outer") == [15.0]
    assert profiling.device_ms("sst.inner") == [2.0, 4.0]
    assert profiling.device_ms("sst.host") == profiling.device_ms("inner") == []
    for _, start, end in profiling._DEVICE_SPANS:  # both on the stream current at the opening
        assert end.synced and set(start.streams) == set(end.streams) == {STREAM}
    # each is also its host event, the inner ones inside the outer
    (outer,) = _spans(prof, "sst.outer")
    inner = _spans(prof, "sst.inner")
    assert len(inner) == 2 and all(_inside(i, outer) for i in inner)
    profiling.clear_device_spans()
    assert profiling._DEVICE_SPANS == [] and profiling.device_ms("sst.inner") == []


@pytest.mark.parametrize("cuda", ["not initialised", "capturing"])
def test_device_span_is_the_host_event_alone_without_a_stream_to_time(fake_cuda, monkeypatch,
                                                                      cuda):
    monkeypatch.setattr(torch.cuda, "Event", _NoEvent)
    if cuda == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    else:
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("stream.fetch", device=True):
            pass
    assert len(_spans(prof, "sst.stream.fetch")) == 1
    assert profiling._DEVICE_SPANS == []


def _tasnet() -> ConvTasNet:
    return ConvTasNet(**TINY_TASNET, generator=torch.Generator().manual_seed(0)).eval()


def _stream(model: ConvTasNet, hops: np.ndarray) -> list[np.ndarray]:
    sep = StreamingSeparator(lambda window: cuda_apply(model, window), sample_rate=SR,
                             hop_seconds=HOP / SR, context_seconds=CONTEXT / SR)
    with plain_versions():
        return [sep.push(h) for h in hops]


@pytest.fixture(scope="module")
def streamed():
    """Three pushes of the window engine through ``cuda_apply``'s plain trunk,
    profiled, and the same pushes unprofiled."""
    model = _tasnet()
    hops = np.random.default_rng(1).standard_normal((PUSHES, HOP)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _stream(model, hops)
    return prof, outs, _stream(model, hops)


def test_stream_spans_once_a_push_nested_and_apart(streamed):
    prof = streamed[0]
    apply, fetch = _spans(prof, "sst.stream.apply"), _spans(prof, "sst.stream.fetch")
    weights = _spans(prof, "sst.tasnet.weights")
    assert len(apply) == len(fetch) == len(weights) == PUSHES
    for a, f, w in zip(apply, fetch, weights):
        assert _inside(w, a)  # the weights' lookup is part of the enqueue
        assert a[1] <= f[0]  # the fetch follows its own hop's launches
    assert not any(_overlap(a, f) for a in apply for f in fetch)
    # the first push builds the model's serving weights, every later one hits
    hits = _spans(prof, "sst.tasnet.weights.hit")
    assert len(hits) == PUSHES - 1
    assert all(_inside(h, w) for h, w in zip(hits, weights[1:]))


def test_stream_outputs_unchanged_by_the_profiler(streamed):
    _, traced, plain = streamed
    for a, b in zip(traced, plain):
        np.testing.assert_array_equal(a, b)


def test_spans_are_host_events_not_user_annotations(streamed, fake_cuda):
    ours = [e for e in _events(streamed[0]) if e.name().startswith("sst.")]
    assert {e.name() for e in ours} == {"sst.stream.apply", "sst.stream.fetch",
                                        "sst.tasnet.weights", "sst.tasnet.weights.hit"}
    assert not any(e.is_user_annotation() for e in ours)
    # a device span too: its host side is the same plain function event
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("stream.fetch", device=True):
            pass
    (fetch,) = [e for e in _events(prof) if e.name() == "sst.stream.fetch"]
    assert not fetch.is_user_annotation()
    assert _device_names() == ["sst.stream.fetch"]


class _Batch(NamedTuple):
    mix: np.ndarray
    lengths: np.ndarray
    name: str


def test_feed_pins_once_a_batch():
    batches = [_Batch(np.full((2, 64), i, np.float32), np.array([64, 40], np.int32), f"b{i}")
               for i in range(4)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = list(prefetch_to_device(iter(batches), "cpu"))
    assert [b.name for b in got] == ["b0", "b1", "b2", "b3"]
    assert len(_spans(prof, "sst.feed.pin")) == 4


def _upit_step():
    model = UPitBlstm(hidden=8, num_layers=1, generator=torch.Generator().manual_seed(0))
    step, _ = train.make_upit_waveform_steps(model)
    rng = np.random.default_rng(2)
    samples = 1024
    mix = torch.from_numpy(rng.integers(-3000, 3000, (2, samples)).astype(np.int16))
    sources = torch.from_numpy(rng.integers(-3000, 3000, (2, 2, samples)).astype(np.int16))
    frames = torch.tensor([9, 6], dtype=torch.int32)
    return model, train.adam(1e-3), step, (mix, sources, frames), 0


def _tasnet_step():
    model = ConvTasNet(**TINY_TASNET, generator=torch.Generator().manual_seed(0))
    step, _ = train.make_time_domain_steps(model)
    rng = np.random.default_rng(3)
    samples = 512
    mix = torch.from_numpy(rng.standard_normal((2, samples)).astype(np.float32))
    sources = torch.from_numpy(rng.standard_normal((2, 2, samples)).astype(np.float32))
    return model, train.adam(1e-3), step, (mix, sources, torch.tensor([512, 400])), 0


def _vae_step():
    model = VqVaeCodebook(embedding_dim=8, num_embeddings=16,
                          generator=torch.Generator().manual_seed(0))
    step, _ = train.make_vae_steps(model)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, 40)).astype(np.float32))
    return model, train.nadam(1e-3), step, (x, x.clone()), 0


@pytest.mark.parametrize("factory", [_upit_step, _tasnet_step, _vae_step],
                         ids=["upit_waveform", "time_domain", "vae"])
def test_train_step_spans_forward_then_backward(factory):
    model, tx, step, args, seed = factory()
    model.train()
    state = train.TrainState.create(model, tx, seed)
    with plain_versions(), profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(STEPS):
            out = step(state, *args)
            state = out[0]
    forward, backward = _spans(prof, "sst.train.forward"), _spans(prof, "sst.train.backward")
    adam = _spans(prof, ADAM)
    assert len(forward) == len(backward) == len(adam) == STEPS
    order = sorted([(s, "forward") for s, _ in forward] + [(s, "backward") for s, _ in backward])
    assert [kind for _, kind in order] == ["forward", "backward"] * STEPS
    for f, b in zip(forward, backward):
        assert f[1] <= b[0]
    # the optimizer's update keeps torch's own span, outside the port's
    assert not any(_overlap(a, s) for a in adam for s in forward + backward)


@pytest.mark.parametrize("factory", [_upit_step, _tasnet_step, _vae_step],
                         ids=["upit_waveform", "time_domain", "vae"])
def test_train_step_times_the_backward_on_the_device(fake_cuda, factory):
    model, tx, step, args, seed = factory()
    model.train()
    state = train.TrainState.create(model, tx, seed)
    with plain_versions(), profile(activities=[ProfilerActivity.CPU]):
        for _ in range(STEPS):
            state = step(state, *args)[0]
    # the backward's pair a step; the forward stays a host span
    assert _device_names() == ["sst.train.backward"] * STEPS


TINY_DPRNN = dict(enc_dim=8, bottleneck=8, hidden=8, chunk=10, blocks=3)
DPRNN_SPANS = ("sst.dprnn.encode", "sst.dprnn.intra", "sst.dprnn.inter", "sst.dprnn.decode")


def _dprnn_forwards(count: int) -> list[torch.Tensor]:
    model = DPRNN(**TINY_DPRNN, generator=torch.Generator().manual_seed(0)).eval()
    mix = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 77)).astype(np.float32))
    with torch.no_grad():
        return [model(mix) for _ in range(count)]


def test_dprnn_spans_once_a_block_a_forward_in_order():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = _dprnn_forwards(2)
    blocks = TINY_DPRNN["blocks"]
    encode, decode = _spans(prof, "sst.dprnn.encode"), _spans(prof, "sst.dprnn.decode")
    intra, inter = _spans(prof, "sst.dprnn.intra"), _spans(prof, "sst.dprnn.inter")
    assert len(encode) == len(decode) == 2 and len(intra) == len(inter) == 2 * blocks
    for f in range(2):  # encode, then intra and inter a block, then decode, none overlapping
        order = [encode[f]] + [s for pair in zip(intra[f * blocks:(f + 1) * blocks],
                                                 inter[f * blocks:(f + 1) * blocks]) for s in pair]
        order.append(decode[f])
        assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))
    ours = [e for e in _events(prof) if e.name().startswith("sst.dprnn.")]
    assert {e.name() for e in ours} == set(DPRNN_SPANS)
    assert not any(e.is_user_annotation() for e in ours)  # host events: no GPU mirror
    for a, b in zip(traced, _dprnn_forwards(2)):  # the outputs unchanged by the profiler
        assert torch.equal(a, b)


def test_dprnn_spans_build_nothing_with_the_profiler_off(monkeypatch):
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _Counting)
    monkeypatch.setattr(_Counting, "built", [])
    _dprnn_forwards(1)
    assert _Counting.built == []


def _dprnn() -> DPRNN:
    return DPRNN(**TINY_DPRNN, generator=torch.Generator().manual_seed(0)).eval()


def _sepformer() -> SepFormer:
    return SepFormer(enc_dim=8, win=16, d_model=8, heads=2, ffn=16, layers=1, chunk=8, blocks=2,
                     generator=torch.Generator().manual_seed(0)).eval()


def _tfgridnet() -> TFGridNet:
    return TFGridNet(n_fft=16, hop=4, d_model=8, blocks=2, kernel=3, hidden=6, heads=2, qk_dim=16,
                     generator=torch.Generator().manual_seed(0)).eval()


@pytest.mark.parametrize("build, model, blocks, parts", [
    (_dprnn, "dprnn", TINY_DPRNN["blocks"], ("intra", "inter")),
    (_sepformer, "sepformer", 2, ("intra", "inter")),
    (_tfgridnet, "tfgridnet", 2, ("intra", "inter", "attention")),
], ids=["dprnn", "sepformer", "tfgridnet"])
def test_device_spans_cover_a_forward_encode_blocks_decode(fake_cuda, build, model, blocks, parts):
    net = build()
    mix = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 96)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        net(mix)
    want = ([f"sst.{model}.encode"] + [f"sst.{model}.{p}" for _ in range(blocks) for p in parts]
            + [f"sst.{model}.decode"])
    assert _device_names() == want  # once each, in the forward's order
    host = sorted((s, name) for name in set(want) for s, _ in _spans(prof, name))
    assert [name for _, name in host] == want  # each pair is its host span's too
