"""The ``dprnn`` configuration and the readers of its cell, on synthetic
traces: the recurrence's bound counted from the batches' work, whatever the
launches' slicing; the launches a batch; the dual-path spans' host ms. The
cell's control and planted faults come out not correct. Also registers the
configuration's toy widths for the whole-run tests."""

import importlib.util
import json
import math
import time

import pytest
from conftest import ROOT, TINY_CFG, tiny_cell

from bench_torch import counts, harness
from bench_torch import trace as tr
from bench_torch.counts_dprnn import dual_path_bound_s, dual_path_rows
from bench_torch.readers import Window

# toy widths for test_run.py's whole runs of the cell (K = 40 frames, P = 20)
TINY_CFG.setdefault("dprnn", {"enc_dim": 8, "bottleneck": 8, "hidden": 8, "chunk": 40, "blocks": 2})

MS = 1_000_000  # ns
SERVING = "void lstm_fwd_persistent_kernel<float, false>(Args)"
TRAINING = "void lstm_fwd_persistent_kernel<float, true>(Args)"


def _cfg() -> dict:
    return json.loads((harness.HERE / "configs" / "dprnn.json").read_text())


def _reader(metric: str):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _reference():
    spec = importlib.util.spec_from_file_location("ref_dprnn", harness.HERE / "reference" / "dprnn.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ITEMS = [{"rows": 16, "samples": 80_000}, {"rows": 16, "samples": 16_000}]


def _trace(kernel_ms: list[float], names=None, host=()) -> tr.Trace:
    """A window of 10 s whose device ran ``kernel_ms`` back to back."""
    device, at = [], 0
    for i, ms in enumerate(kernel_ms):
        name = names[i] if names else SERVING
        device.append(tr.Event(name, at, at + int(ms * MS), "kernel"))
        at += int(ms * MS)
    spans = [tr.Event("bench.window", 0, 10_000 * MS, "user_annotation")]
    spans += [tr.Event(n, s * MS, e * MS, "cpu_op") for n, s, e in host]
    return tr.Trace(device, spans, 0, 10_000 * MS)


def _window(trace, items=ITEMS) -> Window:
    return Window(_cfg(), 10.0, items, 0.0, 1, 1.0, trace)


def test_dual_path_rows_at_ten_seconds():
    # 80,000 frames at stride 1: S = 640 + 1 chunks of K = 250
    assert dual_path_rows(_cfg(), 16, 80_000) == ((16 * 641, 250), (16 * 250, 641))
    assert dual_path_rows(_cfg(), 16, 16_000) == ((16 * 129, 250), (16 * 250, 129))


def test_bound_by_hand_and_not_by_slices():
    cfg = _cfg()
    want = 6 * (counts.lstm_serving_bound_s(10_256, 250, 128)
                + counts.lstm_serving_bound_s(4_000, 641, 128))
    assert dual_path_bound_s(cfg, 16, 80_000) == pytest.approx(want, rel=1e-12)
    # bound by operations: 2 dirs x 2 x rows x steps x H x 4H at 67 TFLOP/s
    flops = 6 * 2 * 2 * (10_256 * 250 + 4_000 * 641) * 128 * 512
    assert want == pytest.approx(flops / 67e12, rel=1e-9)
    # the row slices of 256 the program launches today would count U once a slice
    sliced = 6 * (sum(counts.lstm_serving_bound_s(r, 250, 128) for r in counts.row_slices(10_256))
                  + sum(counts.lstm_serving_bound_s(r, 641, 128) for r in counts.row_slices(4_000)))
    assert sliced == pytest.approx(want, rel=1e-12)  # by operations, either way


def test_roofline_does_not_depend_on_the_slicing():
    read = _reader("dprnn_recurrence_roofline")
    bound_ms = 1e3 * sum(dual_path_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    total = 4 * bound_ms  # 25% of the bound
    few = read(_window(_trace([total / 2, total / 2])))
    many = read(_window(_trace([total / 342] * 342)))
    assert few == pytest.approx(25.0, rel=1e-6) and many == pytest.approx(25.0, rel=1e-6)


def test_roofline_reads_only_the_serving_launches():
    read = _reader("dprnn_recurrence_roofline")
    bound_ms = 1e3 * sum(dual_path_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    trace = _trace([2 * bound_ms, 50.0, 7.0], names=[SERVING, TRAINING, "void gemm<float>(P)"])
    assert read(_window(trace)) == pytest.approx(50.0, rel=1e-6)
    assert read(_window(_trace([5.0], names=[TRAINING]))) is None  # no serving launch
    assert read(_window(None)) is None


def test_launches_a_batch():
    read = _reader("lstm_launches.dprnn")
    assert read(_window(_trace([1.0] * 342 + [2.0], names=[SERVING] * 342 + [TRAINING]))) == 171.0
    assert read(_window(_trace([1.0], names=[TRAINING]))) is None
    assert read(_window(None)) is None


def test_dual_path_ms_a_batch():
    read = _reader("dual_path_ms.dprnn")
    host = [("sst.dprnn.intra", 10, 13), ("sst.dprnn.inter", 13, 18), ("sst.dprnn.intra", 30, 32),
            ("sst.dprnn.segment", 1, 2), ("sst.dprnn.merge", 40, 50)]
    assert read(_window(_trace([1.0], host=host))) == pytest.approx(5.0)  # (3 + 5 + 2) / 2 items
    assert read(_window(_trace([1.0], host=[("sst.dprnn.merge", 1, 2)]))) is None  # a parent
    assert read(_window(None)) is None


def test_idle_and_mfu_read_as_the_separate_cells_do():
    trace = _trace([2_500.0])
    assert _reader("device_idle.dprnn")(_window(trace)) == pytest.approx(75.0)
    w = Window(_cfg(), 10.0, [{"frames": 1_000}], 0.0, 67, 67.0, trace)
    assert _reader("mfu.dprnn")(w) == pytest.approx(100.0 * 67 * 1_000 / 10.0 / 67.0)


def test_flops_a_frame_by_hand():
    # both halves of 6 blocks: 2 dirs x (64x512 input + 128x512 recurrent) + 256x64 linear, on
    # each frame's 2 chunk frames; encoder 2x64, bottleneck 64x64, mask 64x128 on 2, decoder 2x64x2
    half = 2 * (64 * 512 + 128 * 512) + 256 * 64
    total = 2 * 64 + 64 * 64 + 2 * (6 * 2 * half + 64 * 128) + 2 * 64 * 2
    assert _reference().flops_per_frame(_cfg()) == 2 * total == 10_265_344


def test_parameter_count_and_widths_match_the_paper():
    cfg = _cfg()
    keys = ("enc_dim", "win", "bottleneck", "hidden", "chunk", "blocks", "num_speakers")
    assert tuple(cfg[k] for k in keys) == (64, 2, 64, 128, 250, 6, 2)
    assert "hop" not in cfg  # P = K/2, as the module computes it
    shapes = _reference().param_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"] == 2_583_426
    assert round(cfg["parameters"] / 1e5) == 26  # the paper's 2.6M
    assert cfg["reduced"] == []


def test_the_cell_reports_the_five_metrics():
    cell = harness.Cell.find("dprnn_separate")
    assert {m["name"] for m in cell.per_layer} == {
        "dprnn_recurrence_roofline", "lstm_launches.dprnn", "device_idle.dprnn", "mfu.dprnn",
        "dual_path_ms.dprnn"}
    assert {m["name"] for m in cell.end_to_end} == {"separate_rtf", "setup_s"}
    assert (ROOT / "bench_torch" / "limits" / "dprnn_separate.json").is_file()


@pytest.mark.parametrize("mode,fault", [("control", None), ("program", "answer_altered"),
                                        ("program", "half_batch")])
def test_control_and_faults_come_out_not_correct(mode, fault, cpu):
    """As ``test_checks.py`` holds the other cells: the reference in TF32 in
    the program's place, and each fault planted in the timed path."""
    cell = tiny_cell("dprnn_separate")
    assert cell.limits
    result = harness.run_cell(cell, 2**31 + 29, 0.3, False, t_start=time.perf_counter(), device=cpu,
                              mode=mode, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
