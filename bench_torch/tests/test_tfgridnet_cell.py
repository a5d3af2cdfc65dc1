"""The ``tfgridnet`` configuration and the readers of its cell, on synthetic
traces: the attention scores' and the recurrences' bounds counted from the
batches' work by hand, whatever the launches; the launches a batch; the
block spans' host ms; the FLOPs a frame by hand. The cell's fp8 control and
planted faults come out not correct. Also registers the configuration's toy
widths for the whole-run tests."""

import importlib.util
import json
import math
import time

import pytest
from conftest import ROOT, TINY_CFG, tiny_cell

from bench_torch import counts, harness
from bench_torch import trace as tr
from bench_torch.counts_tfgridnet import (
    grid,
    is_scores,
    recurrence_bound_s,
    recurrence_rows,
    scores_bound_s,
    scores_call_bound_s,
)
from bench_torch.readers import Window

# toy widths for the whole runs of the cell: F = 17 bins, E = 2, 200-600 frames, and the
# published 4 blocks, through which the fp8 control's error grows as at full width (0.13-0.20
# here over four seeds, 0.25-0.27 at full width; 1 block reads 0.05-0.11)
TINY_CFG.setdefault("tfgridnet", {"n_fft": 32, "hop": 8, "d_model": 16, "blocks": 4, "kernel": 4,
                                  "hidden": 16, "heads": 2, "qk_dim": 34})

MS = 1_000_000  # ns
SCORES = ("void (anonymous namespace)::wide_attention_scores_kernel<4>(__nv_bfloat16 const*, "
          "__nv_bfloat16 const*, __nv_bfloat16*, int, int, float, int)")
SERVING = "void (anonymous namespace)::lstm_fwd_persistent_kernel<__nv_bfloat16, false>(Args)"
TRAINING = "void (anonymous namespace)::lstm_fwd_persistent_kernel<__nv_bfloat16, true>(Args)"
GEMM = "nvjet_tst_128x288_64x4_2x1_v_bz_coopA_bias_NNT"


def _cfg() -> dict:
    return json.loads((harness.HERE / "configs" / "tfgridnet.json").read_text())


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reader(metric: str):
    return _module(harness.HERE / "metrics" / f"{metric}.py", "reader_" + metric.replace(".", "_")).read


def _reference():
    return _module(harness.HERE / "reference" / "tfgridnet.py", "ref_tfgridnet")


ITEMS = [{"rows": 16, "samples": 80_000}, {"rows": 16, "samples": 16_000}]


def _trace(kernel_ms: list[float], names=None, host=()) -> tr.Trace:
    """A window of 10 s whose device ran ``kernel_ms`` back to back."""
    device, at = [], 0
    for i, ms in enumerate(kernel_ms):
        device.append(tr.Event(names[i] if names else SCORES, at, at + int(ms * MS), "kernel"))
        at += int(ms * MS)
    spans = [tr.Event("bench.window", 0, 10_000 * MS, "user_annotation")]
    spans += [tr.Event(n, s * MS, e * MS, "cpu_op") for n, s, e in host]
    return tr.Trace(device, spans, 0, 10_000 * MS)


def _window(trace, items=ITEMS) -> Window:
    return Window(_cfg(), 10.0, items, 0.0, 1, 1.0, trace)


def test_grid_at_two_and_ten_seconds_by_hand():
    # 80,000 samples with 192 zeros a side: (80,384 - 256) / 64 + 1 = 1,253 frames of 129 bins
    assert grid(_cfg(), 80_000) == (1_253, 129) and grid(_cfg(), 16_000) == (253, 129)
    assert int(_reference().frames(_cfg(), 80_000)) == 1_253
    assert recurrence_rows(_cfg(), 16, 80_000) == ((16 * 1_253, 126), (16 * 129, 1_250))


def test_scores_bound_at_ten_seconds_by_hand():
    # 64 head-items of 1,253 frames at d = 4 x 129 = 516: Q and K read, P written, bf16
    n, length, depth = 64, 1_253, 516
    nbytes = 2 * (2 * n * length * depth + n * length * length)
    flops = 2 * n * length * length * depth
    assert nbytes == 366_477_440 and flops == 103_695_954_432
    want = max(nbytes / 3.35e12, flops / 989e12)  # bytes, by 4%
    assert scores_call_bound_s(n, length, depth) == pytest.approx(want, rel=1e-12)
    assert scores_bound_s(_cfg(), 16, 80_000) == pytest.approx(4 * want, rel=1e-12)
    assert 4 * want == pytest.approx(0.4376e-3, rel=1e-3)
    # by operations at a longer head: 5,000 frames
    assert scores_call_bound_s(1, 5_000, 516) == pytest.approx(2 * 5_000**2 * 516 / 989e12)
    assert counts.PEAK_FLOPS["bf16"] == 989e12


def test_recurrence_bound_at_ten_seconds_by_hand():
    # intra 20,048 rows x 126 steps and inter 2,064 rows x 1,250 at H = 256, bf16: xw
    # [2, R, S, 1,024] and h [R, S, 512] move 2 bytes each, against 2 x 2 R S 256 x 1,024
    # operations; bytes bound both halves
    def half(rows, steps):
        nbytes = 2 * (2 * rows * steps * 1_024 + 2 * 256 * 1_024 + rows * steps * 512)
        flops = 2 * 2 * rows * steps * 256 * 1_024
        assert nbytes / 3.35e12 > flops / 989e12
        return nbytes / 3.35e12

    want = 4 * (half(20_048, 126) + half(2_064, 1_250))
    assert recurrence_bound_s(_cfg(), 16, 80_000) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(31.2e-3, rel=2e-3)


def test_scores_roofline_reads_only_the_scores_launches():
    read = _reader("attention_scores_roofline.tfgridnet")
    bound_ms = 1e3 * sum(scores_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    trace = _trace([bound_ms, bound_ms, 50.0, 7.0], names=[SCORES, SCORES, GEMM, SERVING])
    assert read(_window(trace)) == pytest.approx(50.0, rel=1e-5)  # launches cut to whole ns
    assert not is_scores(tr.Event(GEMM, 0, 1, "kernel"))
    assert read(_window(_trace([5.0], names=[GEMM]))) is None  # no scores launch
    assert read(_window(None)) is None


def test_recurrence_roofline_and_launches_read_the_serving_kernel_alone():
    roofline = _reader("tfgridnet_recurrence_roofline")
    launches = _reader("lstm_launches.dprnn")  # the one launch counter of row 2
    bound_ms = 1e3 * sum(recurrence_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    # 92 + 28 launches for the two batches, at 10% of the bound in all, a training launch beside
    names = [SERVING] * 120 + [TRAINING, GEMM]
    trace = _trace([10 * bound_ms / 120] * 120 + [30.0, 5.0], names=names)
    assert roofline(_window(trace)) == pytest.approx(10.0, rel=1e-6)
    assert launches(_window(trace)) == pytest.approx(60.0)
    assert roofline(_window(_trace([1.0], names=[GEMM]))) is None
    assert launches(_window(_trace([1.0], names=[TRAINING]))) is None
    assert roofline(_window(None)) is None and launches(_window(None)) is None


def test_grid_ms_a_batch():
    read = _reader("grid_ms.tfgridnet")
    host = [("sst.tfgridnet.intra", 10, 13), ("sst.tfgridnet.inter", 13, 18),
            ("sst.tfgridnet.attention", 18, 20), ("sst.tfgridnet.encode", 1, 2),
            ("sst.tfgridnet.decode", 40, 50), ("sst.dprnn.intra", 60, 70)]
    assert read(_window(_trace([1.0], host=host))) == pytest.approx(5.0)  # (3 + 5 + 2) / 2 items
    assert read(_window(_trace([1.0], host=[("sst.dprnn.inter", 1, 2)]))) is None
    assert read(_window(None)) is None


def test_flops_a_frame_by_hand():
    # a block at T = 753: intra 126 windows of the BiLSTM (2 x (512 x 1,024 + 256 x 1,024)
    # multiply-adds) and the transposed conv (512 x 512); inter 129 rows at 750 / 753 windows
    # a frame; the 1x1s 129 x 128 x (2 x 16 + 128 + 128); the products 753 x 129 x 4 x (4 + 32)
    window = 2 * (512 * 1_024 + 256 * 1_024) + 512 * 512
    block = (126 * window + 129 * 750 * window // 753 + 129 * 128 * (32 + 128 + 128)
             + 753 * 129 * 4 * 36)
    total = 2 * (129 * 2 * 9 * 128 + 4 * block + 129 * 128 * 9 * 4)
    assert _reference().flops_per_frame(_cfg()) == total
    assert total == pytest.approx(3.888e9, rel=1e-3)  # ~486 GFLOP an audio second


def test_parameter_count_and_widths_match_the_paper():
    cfg = _cfg()
    keys = ("n_fft", "hop", "d_model", "blocks", "kernel", "hidden", "heads", "qk_dim", "num_speakers")
    assert tuple(cfg[k] for k in keys) == (256, 64, 128, 4, 4, 256, 4, 512, 2)
    shapes = _reference().param_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"] == 15_152_696
    assert cfg["reduced"] == [] and cfg["precision"] == "bf16" and cfg["control_precision"] == "fp8"


def test_the_cell_reports_its_metrics():
    cell = harness.Cell.find("tfgridnet_separate")
    assert {m["name"] for m in cell.per_layer} == {
        "attention_scores_roofline.tfgridnet", "tfgridnet_recurrence_roofline",
        "lstm_launches.dprnn", "grid_ms.tfgridnet", "device_idle.separate", "mfu.separate",
        "copy_ms.separate"}
    assert {m["name"] for m in cell.end_to_end} == {"separate_rtf", "setup_s"}
    assert cell.chips == 1 and cell.traffic["batch"] == 16
    assert (ROOT / "bench_torch" / "limits" / "tfgridnet_separate.json").is_file()


@pytest.mark.parametrize("mode,fault", [("control", None), ("program", "answer_altered"),
                                        ("program", "half_batch")])
def test_control_and_faults_come_out_not_correct(mode, fault, cpu):
    """As ``test_checks.py`` holds the other cells: the reference in fp8 in
    the program's place, and each fault planted in the timed path."""
    cell = tiny_cell("tfgridnet_separate")
    assert cell.limits
    result = harness.run_cell(cell, 2**31 + 31, 0.3, False, t_start=time.perf_counter(), device=cpu,
                              mode=mode, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_the_program_comes_out_correct(cpu):
    cell = tiny_cell("tfgridnet_separate")
    result = harness.run_cell(cell, 2**31 + 37, 0.3, False, t_start=time.perf_counter(), device=cpu)
    assert result["correct"] is True, result["checks"]
