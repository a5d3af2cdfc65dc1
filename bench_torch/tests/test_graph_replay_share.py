"""The reader of ``graph_replay_share.stream``: the share of the window's
``sst.tasnet.weights`` spans (one a ``cuda_apply`` call) matched by an
``sst.tasnet.graph.replay``, 0 for a program that records the lookup and no
replay, nothing untraced or without the lookup's span; and, on a card, a
replay every hop from the third on, none among the device's events."""

import importlib.util

import numpy as np
import pytest
import torch

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window

METRIC = "graph_replay_share.stream"
CALL, REPLAY = "sst.tasnet.weights", "sst.tasnet.graph.replay"
MS = 1_000_000  # ns


def _read(trace, items: int = 4):
    path = harness.HERE / "metrics" / f"{METRIC}.py"
    spec = importlib.util.spec_from_file_location("reader_graph_replay_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(Window({}, 1.0, [{}] * items, 0.0, 1, 1.0, trace))


def _trace(calls: int, replays: int) -> tr.Trace:
    """A window of 100 ms with ``calls`` lookups 10 ms apart, each of the
    last ``replays`` followed by a replay, and one of each after the window."""
    ev = tr.Event
    host = [ev("bench.window", 0, 100 * MS, "user_annotation")]
    for i in range(calls):
        start = (10 * i + 1) * MS
        host.append(ev(CALL, start, start + MS, "cpu_op"))
        if i >= calls - replays:
            host.append(ev(REPLAY, start + 2 * MS, start + 3 * MS, "cpu_op"))
    host += [ev(CALL, 150 * MS, 151 * MS, "cpu_op"), ev(REPLAY, 152 * MS, 153 * MS, "cpu_op")]
    return tr.Trace([ev("void k<1>(P)", 0, 5 * MS, "kernel")], host, 0, 100 * MS)


@pytest.mark.parametrize("calls, replays, share", [(4, 3, 75.0), (5, 5, 100.0), (8, 2, 25.0)])
def test_replays_over_lookups(calls, replays, share):
    assert _read(_trace(calls, replays)) == pytest.approx(share)


def test_lookups_without_a_replay_read_zero():
    assert _read(_trace(6, 0)) == 0.0  # a program that launches every kernel itself


def test_nothing_untraced_or_without_the_lookup_span():
    assert _read(None) is None
    assert _read(_trace(0, 0)) is None
    stripped = _trace(3, 3)
    stripped.host = [e for e in stripped.host if e.name != CALL]
    assert _read(stripped) is None


def test_declared_for_the_stream_cell():
    (m,) = [m for m in harness.load_benchmark()["per_layer"] if m["name"] == METRIC]
    assert (m["unit"], m["better"], m["source"]) == ("%", "higher", "program_span")
    assert m["layer"] == "streaming engine"
    assert m["workloads"] == ["tasnet_stream"] and m["moves"] == "stream_hop_p95_ms"
    assert METRIC in {x["name"] for x in harness.Cell.find("tasnet_stream").per_layer}


@pytest.mark.cuda
def test_stream_replays_every_hop_from_the_third_and_nothing_on_the_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from conftest import tiny_cell

    from bench_torch.programs.conv_tasnet import stream_apply
    from speech_separation_tpu_torch.models.tasnet import ConvTasNet
    from speech_separation_tpu_torch.separate.streaming import StreamingSeparator

    device = torch.device("cuda", 0)
    cell = tiny_cell("tasnet_stream")
    cfg, traffic = cell.cfg, cell.traffic
    model = ConvTasNet(cfg["num_speakers"], cfg["enc_dim"], cfg["win"], cfg["bottleneck"],
                       cfg["hidden"], cfg["kernel"], cfg["blocks"], cfg["repeats"], cfg["causal"],
                       generator=torch.Generator().manual_seed(0)).to(device).eval()
    sr = traffic["sample_rate"]
    sep = StreamingSeparator(stream_apply(model, cfg, device), num_speakers=cfg["num_speakers"],
                             sample_rate=sr, hop_seconds=traffic["hop_seconds"],
                             context_seconds=traffic["context_seconds"])
    hop = int(round(traffic["hop_seconds"] * sr))
    hops = 6
    mix = np.random.default_rng(0).standard_normal(hops * hop).astype(np.float32)
    with tr.record(True) as capture:
        with tr.span("window", True):
            for h in range(hops):
                sep.push(mix[h * hop:(h + 1) * hop])
        torch.cuda.synchronize()
    trace = capture.trace
    assert len(tr.host_events(trace, CALL)) == hops
    assert len(tr.host_events(trace, REPLAY)) == hops - 2
    assert _read(trace, hops) == pytest.approx(100.0 * (hops - 2) / hops)
    assert tr.device_events(trace)  # the hops ran on the card
    assert not any(e.name.startswith("sst.") for e in trace.device)
