"""The readers of the program's own spans (``sst.*``, recorded by
``speech_separation_tpu_torch.utils.span``): host ms an item, nothing where
the span is absent (a program without it) or the run is untraced."""

import importlib.util

import pytest

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window

# metric -> the span it reads
PER_ITEM = {
    "enqueue_ms.stream": "sst.stream.apply",
    "weights_ms.stream": "sst.tasnet.weights",
    "fetch_ms.stream": "sst.stream.fetch",
    "forward_ms.train": "sst.train.forward",
    "backward_ms.train": "sst.train.backward",
}
PER_SPAN = {"pin_ms.separate": "sst.feed.pin", "pin_ms.train": "sst.feed.pin"}
MS = 1_000_000  # ns


def _read(metric: str, trace, items: int = 2):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(Window({}, 1.0, [{}] * items, 0.0, 1, 1.0, trace))


def _trace(name: str, spans) -> tr.Trace:
    """A window of 100 ms whose host thread holds ``spans`` of ``name``
    (``(start, end)`` in ms), a harness span and an op inside the first."""
    ev = tr.Event
    host = [ev("bench.window", 0, 100 * MS, "user_annotation"),
            ev("bench.push", 0, 40 * MS, "user_annotation")]
    host += [ev(name, s * MS, e * MS, "cpu_op") for s, e in spans]
    host.append(ev("aten::copy_", spans[0][0] * MS, spans[0][0] * MS + 1, "cpu_op"))
    host.append(ev(name, 150 * MS, 160 * MS, "cpu_op"))  # after the window: left out
    return tr.Trace([ev("void k<1>(P)", 0, 5 * MS, "kernel")], host, 0, 100 * MS)


@pytest.mark.parametrize("metric", sorted(PER_ITEM))
def test_host_ms_an_item(metric):
    trace = _trace(PER_ITEM[metric], [(1, 4), (10, 15)])
    assert _read(metric, trace) == pytest.approx(4.0)  # (3 + 5) ms over 2 items
    assert _read(metric, _trace("sst.other", [(1, 4)])) is None  # another span's events


@pytest.mark.parametrize("metric", sorted(PER_SPAN))
def test_pin_ms_is_the_mean_over_the_pinned_batches(metric):
    # three batches pinned for two items: the feed pins one ahead
    trace = _trace(PER_SPAN[metric], [(1, 3), (20, 24), (50, 56)])
    assert _read(metric, trace) == pytest.approx(4.0)


@pytest.mark.parametrize("metric", sorted(PER_ITEM) + sorted(PER_SPAN))
def test_nothing_without_a_trace_or_the_span(metric):
    assert _read(metric, None) is None
    assert _read(metric, _trace("bench.feed", [(1, 4)])) is None  # a parent without the span


def test_every_program_span_metric_is_declared_for_its_cell():
    bench = harness.load_benchmark()
    declared = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    for metric in list(PER_ITEM) + list(PER_SPAN):
        m = declared[metric]
        assert (m["unit"], m["better"]) == ("ms", "lower")
        (cell,) = m["workloads"]
        assert metric in {x["name"] for x in harness.Cell.find(cell).per_layer}
