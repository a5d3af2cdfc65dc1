"""The readers of the program's device spans (``sst.*`` spans recorded with
``device=True``, read through ``utils/profiling.py::device_ms``): Σ device
ms of their spans over the window's items; nothing untraced, on a program
without ``device_ms``, or without their spans; each declared for its cells."""

import importlib.util

import pytest

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window
from speech_separation_tpu_torch.utils import profiling

# metric -> (the spans it sums, the cells it is declared for, the end-to-end metric it moves)
READERS = {
    "dual_path_device_ms.dprnn": (("sst.dprnn.intra", "sst.dprnn.inter"), ["dprnn_separate"],
                                  "separate_rtf"),
    "transformer_device_ms.sepformer": (("sst.sepformer.intra", "sst.sepformer.inter"),
                                        ["sepformer_separate"], "separate_rtf"),
    "grid_device_ms.tfgridnet": (("sst.tfgridnet.intra", "sst.tfgridnet.inter",
                                  "sst.tfgridnet.attention"), ["tfgridnet_separate"], "separate_rtf"),
    "ends_device_ms.separate": (tuple(f"sst.{m}.{end}" for m in ("dprnn", "sepformer", "tfgridnet")
                                      for end in ("encode", "decode")),
                                ["dprnn_separate", "sepformer_separate", "tfgridnet_separate"],
                                "separate_rtf"),
    "backward_device_ms.train": (("sst.train.backward",), ["blstm_train"], "train_audio_s_per_s"),
    "fetch_device_ms.stream": (("sst.stream.fetch",), ["tasnet_stream"], "stream_hop_p95_ms"),
}
ITEMS = 4
MS = 1_000_000  # ns


def _read(metric: str, traced: bool = True):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    trace = tr.Trace([], [tr.Event("bench.window", 0, 100 * MS, "user_annotation")], 0, 100 * MS)
    return module.read(Window({}, 1.0, [{}] * ITEMS, 0.0, 1, 1.0, trace if traced else None))


def _fake(times: dict[str, list[float]]):
    """A ``device_ms`` over fixed pairs, ``{span: [ms, ...]}``."""
    return lambda name: list(times.get(name, []))


@pytest.mark.parametrize("metric", sorted(READERS))
def test_sum_of_the_spans_device_ms_over_the_items(metric, monkeypatch):
    spans = READERS[metric][0]
    times = {name: [1.0 + i, 0.5 * (i + 1)] for i, name in enumerate(spans)}
    times["sst.other"] = [100.0]  # another span: left out
    monkeypatch.setattr(profiling, "device_ms", _fake(times), raising=False)
    want = sum(sum(times[name]) for name in spans) / ITEMS
    assert _read(metric) == pytest.approx(want)
    # one span of the set alone still reads (a cell runs one model's ends)
    monkeypatch.setattr(profiling, "device_ms", _fake({spans[-1]: [2.0, 6.0]}), raising=False)
    assert _read(metric) == pytest.approx(8.0 / ITEMS)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_untraced_without_the_function_or_the_spans(metric, monkeypatch):
    spans = READERS[metric][0]
    monkeypatch.setattr(profiling, "device_ms", _fake({spans[0]: [3.0]}), raising=False)
    assert _read(metric, traced=False) is None
    monkeypatch.setattr(profiling, "device_ms", _fake({"sst.other": [3.0]}), raising=False)
    assert _read(metric) is None  # no span of its own recorded
    monkeypatch.delattr(profiling, "device_ms", raising=False)
    assert _read(metric) is None  # a program whose profiling module predates device spans


@pytest.mark.parametrize("metric", sorted(READERS))
def test_declared_for_exactly_its_cells(metric):
    _, cells, moves = READERS[metric]
    declared = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    m = declared[metric]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == ("ms", "lower", "program_span", moves)
    assert m["workloads"] == cells
    for cell in {c["name"] for c in harness.load_benchmark()["workloads"]}:
        assert (metric in {x["name"] for x in harness.Cell.find(cell).per_layer}) == (cell in cells)
