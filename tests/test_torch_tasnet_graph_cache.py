"""``cuda_apply``'s CUDA graph (``models/tasnet_serving.py``) on the CPU:
the policy that picks eager, capture or replay by a call's key
(``_Graphs``), the key itself, a replay's copy in and copy out
(``_Replay``), and ``cuda_apply``'s path through them with the capture and
the stream stood in for, since a graph needs a card. Only calls inside
``ops.fixed_shape_calls()`` reach the graph, which ``StreamingSeparator``
declares around its window; a CPU tensor never does. The capture and the replay on the card are in
``tests/test_torch_cuda.py``."""

from __future__ import annotations

import types

import pytest
import torch

from speech_separation_tpu_torch.models import tasnet_serving as serving
from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import _CAPTURE, _Graphs, _graph_key
from speech_separation_tpu_torch.ops import fixed_shape_calls, plain_versions
from speech_separation_tpu_torch.ops.dispatch import in_fixed_shape_calls
from speech_separation_tpu_torch.ops.mask_decode_cuda import mask_decode
from speech_separation_tpu_torch.ops.tcn_cuda import tcn_trunk_cuda
from speech_separation_tpu_torch.separate.streaming import StreamingSeparator

BF16_PAIR_DB = 30.0  # two bf16 pipelines (tests/test_torch_tasnet.py)
SMALL = dict(num_speakers=2, enc_dim=32, win=16, bottleneck=16, hidden=32, kernel=3, blocks=3,
             repeats=2)


def _stream(handle: int):
    return types.SimpleNamespace(cuda_stream=handle)


def _model() -> ConvTasNet:
    model = ConvTasNet(**SMALL, generator=torch.Generator().manual_seed(0)).eval()
    noise = torch.Generator().manual_seed(100)
    with torch.no_grad():
        for p in model.parameters():  # off the init's unit gammas and zero biases
            p.add_(0.1 * torch.randn(p.shape, generator=noise))
    return model


def _mix(samples: int = 800, seed: int = 1) -> torch.Tensor:
    return 0.3 * torch.randn((1, samples), generator=torch.Generator().manual_seed(seed))


def test_a_key_captures_at_its_second_call_in_a_row_and_replays_at_its_third():
    graphs, key = _Graphs(), ("window",)
    assert graphs.choose(key) is None
    assert graphs.choose(key) is _CAPTURE
    graphs.add(key, "graph")
    assert graphs.choose(key) == "graph"
    assert graphs.choose(key) == "graph"


def test_a_key_between_two_calls_keeps_them_eager():
    """Calls that alternate their shapes never capture."""
    graphs = _Graphs()
    assert [graphs.choose(k) for k in ("a", "b", "a", "b", "c")] == [None] * 5
    assert graphs.choose("c") is _CAPTURE


@pytest.mark.parametrize("change", ["stream", "shape", "dtype"])
def test_a_changed_stream_shape_or_dtype_rekeys(change):
    mix = _mix()
    other = {"stream": (mix, _stream(2)), "shape": (_mix(960), _stream(1)),
             "dtype": (mix.double(), _stream(1))}[change]
    first, second = _graph_key(mix, _stream(1)), _graph_key(*other)
    assert first != second
    assert _graph_key(mix.clone(), _stream(1)) == first  # the values are not part of it
    graphs = _Graphs()
    graphs.choose(first)
    assert graphs.choose(first) is _CAPTURE
    graphs.add(first, "graph")
    assert graphs.choose(second) is None  # another key: eager first
    assert graphs.choose(second) is _CAPTURE
    graphs.add(second, "other graph")  # in place of the first key's
    assert graphs.choose(second) == "other graph"
    assert graphs.choose(first) is None


def test_one_graph_an_entry_a_new_capture_replaces_it():
    graphs = _Graphs()
    for key in ("a", "b"):
        graphs.choose(key)
        assert graphs.choose(key) is _CAPTURE
        graphs.add(key, key.upper())
    assert (graphs.key, graphs.graph) == ("b", "B")
    assert graphs.choose("a") is None  # dropped: eager again, then captured again
    assert graphs.choose("a") is _CAPTURE
    assert graphs.choose("b") == "B"  # held until a capture replaces it


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: its replay writes twice the
    replay's input into its output, past autograd's checks as the device's
    kernels write (the output of a capture in inference mode is an
    inference tensor)."""

    def __init__(self, replay):
        self.target, self.replays = replay, 0

    def replay(self):
        self.replays += 1
        with torch.inference_mode():
            self.target.out.copy_(2 * self.target.mix)


def _fake_replay(mix: torch.Tensor):
    replay = serving._Replay(mix)
    replay.graph, replay.out = _FakeGraph(replay), torch.zeros_like(mix)
    return replay


def test_a_replay_copies_in_replays_and_returns_a_copy_leaving_the_counters():
    """The wrappers' ``launches`` counters count their calls; a replay makes
    none (its kernels are counted on the device, ``tests/test_torch_cuda.py``)."""
    replay = _fake_replay(torch.zeros(1, 8))
    before = tcn_trunk_cuda.launches, mask_decode.launches
    first = replay(torch.arange(8.0)[None])
    kept = first.clone()
    second = replay(torch.ones(1, 8))
    assert replay.graph.replays == 2
    assert (tcn_trunk_cuda.launches, mask_decode.launches) == before
    assert torch.equal(first, kept) and torch.equal(first, 2 * torch.arange(8.0)[None])
    assert torch.equal(second, torch.full((1, 8), 2.0))
    assert first.data_ptr() != replay.out.data_ptr()


@pytest.mark.parametrize("captured_in_inference_mode", [True, False])
def test_a_replay_serves_calls_in_and_out_of_inference_mode(captured_in_inference_mode):
    """A stream served under ``torch.inference_mode()`` and a plain call on
    the same window (or the other way round) share the window's graph."""
    with torch.inference_mode(captured_in_inference_mode):
        replay = _fake_replay(torch.zeros(1, 8))
    assert not replay.mix.is_inference()
    with torch.inference_mode(not captured_in_inference_mode):
        got = replay(torch.ones(1, 8))
    with torch.inference_mode(captured_in_inference_mode):
        again = replay(torch.full((1, 8), 3.0))
    assert torch.equal(got, torch.full((1, 8), 2.0)) and torch.equal(again, torch.full((1, 8), 6.0))


@pytest.mark.parametrize("plain", [False, True])
def test_a_cpu_tensor_never_captures_and_matches_fused_apply(monkeypatch, plain):
    def refused(*args):
        raise AssertionError("a CPU tensor reached a capture")

    monkeypatch.setattr(serving, "_capture", refused)
    model, mix = _model(), _mix()
    with plain_versions(plain), fixed_shape_calls():
        outs = [serving.cuda_apply(model, mix) for _ in range(4)]
    graphs = serving._SERVING[model][1].graphs
    assert graphs.last is None and graphs.graph is None
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    want = serving.fused_apply(model, mix)
    snr = 10 * torch.log10(want.double().square().sum() / (outs[0] - want).double().square().sum())
    assert snr.item() >= BF16_PAIR_DB


@pytest.fixture
def as_if_on_a_card(monkeypatch):
    """``cuda_apply`` on CPU tensors as it runs on a card's: not plain, the
    current stream a stand-in (``streams[0]``), the capture the eager chain
    and a stand-in graph that runs it again on its static input. Yields the
    list of streams and the list of captured keys."""
    streams, captured = [_stream(7)], []
    monkeypatch.setattr(serving, "use_plain", lambda t: False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: streams[0])

    def capture(model, w, mix, stream):
        captured.append(_graph_key(mix, stream))
        replay = serving._Replay(mix)
        replay.out = serving._launch(model, w, replay.mix)
        replay.graph = types.SimpleNamespace(
            replay=lambda: replay.out.copy_(serving._launch(model, w, replay.mix)))
        return replay.out.clone(), replay

    monkeypatch.setattr(serving, "_capture", capture)
    return streams, captured


def _replays(fn) -> int:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.name == "sst.tasnet.graph.replay" for e in prof.events())


def test_cuda_apply_captures_at_the_second_hop_and_replays_after(as_if_on_a_card):
    streams, captured = as_if_on_a_card
    model = _model()
    mixes = [_mix(seed=s) for s in range(6)]
    eager = [serving._launch(model, serving._serving(model), m) for m in mixes]
    outs = []
    with fixed_shape_calls():
        replays = _replays(lambda: outs.extend(serving.cuda_apply(model, m) for m in mixes))
    assert replays == 4 and len(captured) == 1
    for got, want in zip(outs, eager):
        assert torch.equal(got, want)
    streams[0] = _stream(8)  # another stream: eager, then a second capture
    with fixed_shape_calls():
        replays = _replays(lambda: [serving.cuda_apply(model, m) for m in mixes[:3]])
    assert replays == 1 and len(captured) == 2 and captured[0] != captured[1]


def test_calls_outside_fixed_shape_calls_stay_eager(as_if_on_a_card):
    """Bulk batches of one shape back to back: no capture, no replay, no key
    remembered."""
    _, captured = as_if_on_a_card
    model, mix = _model(), _mix()
    outs = []
    replays = _replays(lambda: outs.extend(serving.cuda_apply(model, mix) for _ in range(4)))
    assert replays == 0 and not captured
    assert serving._serving(model).graphs.last is None
    for got in outs:
        assert torch.equal(got, serving._launch(model, serving._serving(model), mix))


def test_streaming_separator_declares_fixed_shape_calls():
    seen = []

    def apply_fn(window):
        seen.append(in_fixed_shape_calls())
        return torch.stack([window, -window], 1)

    sep = StreamingSeparator(apply_fn, hop_seconds=0.1, context_seconds=0.2)
    for _ in range(3):
        sep.push(torch.randn(sep.hop).numpy())
    assert seen == [True] * 3 and not in_fixed_shape_calls()


def test_a_stream_over_cuda_apply_replays_from_its_third_hop(as_if_on_a_card):
    """``StreamingSeparator`` over ``cuda_apply``: the first hop eager, the
    second captured, the rest replayed, each hop equal to the eager chain."""
    _, captured = as_if_on_a_card
    model = _model()
    w = serving._serving(model)
    sep = StreamingSeparator(lambda m: serving.cuda_apply(model, m), hop_seconds=0.05,
                             context_seconds=0.05)
    assert sep.window == 800
    hops = [_mix(sep.hop, seed=10 + i)[0].numpy() for i in range(6)]
    outs = []
    replays = _replays(lambda: outs.extend(sep.push(h) for h in hops))
    assert replays == 4 and len(captured) == 1
    ref = StreamingSeparator(lambda m: serving._launch(model, w, m), hop_seconds=0.05,
                             context_seconds=0.05)
    for got, hop in zip(outs, hops):
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(ref.push(hop)))


def test_a_changed_parameter_drops_the_graphs(as_if_on_a_card):
    _, captured = as_if_on_a_card
    model, mix = _model(), _mix()
    with fixed_shape_calls():
        for _ in range(3):
            serving.cuda_apply(model, mix)
        with torch.no_grad():
            model.decoder.bias.add_(0.05)  # an optimizer's update: a new entry, no graph
        outs = [serving.cuda_apply(model, mix) for _ in range(3)]  # eager, capture, replay
    assert len(captured) == 2
    fresh = ConvTasNet(**SMALL).eval()
    fresh.load_state_dict(model.state_dict())
    want = serving._launch(fresh, serving._serving(fresh), mix)
    for got in outs:
        assert torch.equal(got, want)
