"""The ``sepformer`` configuration and the readers of its cell, on synthetic
traces: the attention's bound counted from the batches' work, whatever the
backend's launches; the transformer spans' host ms; the FLOPs a frame by
hand. The cell's fp8 control and planted faults come out not correct. Also
registers the configuration's toy widths for the whole-run tests."""

import importlib.util
import json
import math
import time

import pytest
from conftest import ROOT, TINY_CFG, tiny_cell

from bench_torch import counts, harness
from bench_torch import trace as tr
from bench_torch.counts_sepformer import attention_bound_s, attention_call_bound_s, is_attention
from bench_torch.readers import Window

# toy widths for test_run.py's whole runs of the cell (K = 8 frames, P = 4)
TINY_CFG.setdefault("sepformer", {"enc_dim": 16, "d_model": 32, "heads": 4, "ffn": 64, "layers": 2,
                                  "chunk": 8, "blocks": 1})

MS = 1_000_000  # ns
FLASH = ("void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<32, 128, 128, 4, false, "
         "false, cutlass::bfloat16_t>, false, false, false, false, true, true, false, false>"
         "(pytorch_flash::Flash_fwd_params)")
SPLIT = "void pytorch_flash::flash_fwd_splitkv_kernel<Flash_fwd_kernel_traits<32>>(Flash_fwd_params)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1"


def _cfg() -> dict:
    return json.loads((harness.HERE / "configs" / "sepformer.json").read_text())


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reader(metric: str):
    return _module(harness.HERE / "metrics" / f"{metric}.py", "reader_" + metric.replace(".", "_")).read


def _reference():
    return _module(harness.HERE / "reference" / "sepformer.py", "ref_sepformer")


ITEMS = [{"rows": 16, "samples": 80_000}, {"rows": 16, "samples": 16_000}]


def _trace(kernel_ms: list[float], names=None, host=()) -> tr.Trace:
    """A window of 10 s whose device ran ``kernel_ms`` back to back."""
    device, at = [], 0
    for i, ms in enumerate(kernel_ms):
        device.append(tr.Event(names[i] if names else FLASH, at, at + int(ms * MS), "kernel"))
        at += int(ms * MS)
    spans = [tr.Event("bench.window", 0, 10_000 * MS, "user_annotation")]
    spans += [tr.Event(n, s * MS, e * MS, "cpu_op") for n, s, e in host]
    return tr.Trace(device, spans, 0, 10_000 * MS)


def _window(trace, items=ITEMS) -> Window:
    return Window(_cfg(), 10.0, items, 0.0, 1, 1.0, trace)


def test_attention_bound_at_ten_seconds_by_hand():
    # 80,000 samples at stride 8: 10,000 frames, S = 80 + 1 chunks of K = 250; intra 1,296
    # chunks of 250, inter 4,000 positions of 81: 324,000 tokens each, Q, K, V and O in bf16
    tokens = 16 * 81 * 250
    nbytes = 4 * tokens * 256 * 2
    assert attention_call_bound_s(16 * 81, 250, 256) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert attention_call_bound_s(4_000, 81, 256) == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    # bound by bytes at both lengths: 4 L d operations a token are under the bf16 peak's share
    assert 4 * 250 * 256 * tokens / 989e12 < nbytes / 3.35e12
    want = 2 * 8 * 2 * nbytes / 3.35e12  # 2 blocks x 8 layers x (intra + inter)
    assert attention_bound_s(_cfg(), 16, 80_000) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(6.338e-3, rel=1e-3)
    # by operations where a sequence is long enough: L = 4,000 at d = 256
    flops = 4 * 4_000 * 256 * 4_000
    assert attention_call_bound_s(1, 4_000, 256) == pytest.approx(flops / 989e12, rel=1e-12)
    assert counts.PEAK_FLOPS["bf16"] == 989e12


def test_roofline_does_not_depend_on_the_launches():
    read = _reader("attention_roofline.sepformer")
    bound_ms = 1e3 * sum(attention_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    total = 4 * bound_ms  # 25% of the bound
    one_a_call = read(_window(_trace([total / 64] * 64)))
    split = read(_window(_trace([total / 3] * 3, names=[FLASH, SPLIT, SPLIT])))
    assert one_a_call == pytest.approx(25.0, rel=1e-6) and split == pytest.approx(25.0, rel=1e-6)


def test_roofline_reads_only_the_attention_launches():
    read = _reader("attention_roofline.sepformer")
    bound_ms = 1e3 * sum(attention_bound_s(_cfg(), it["rows"], it["samples"]) for it in ITEMS)
    trace = _trace([2 * bound_ms, 50.0, 7.0], names=[FLASH, GEMM, "void at::native::vectorized"])
    assert read(_window(trace)) == pytest.approx(50.0, rel=1e-6)
    assert not is_attention(tr.Event(GEMM, 0, 1, "kernel"))
    assert read(_window(_trace([5.0], names=[GEMM]))) is None  # no attention launch
    assert read(_window(None)) is None


def test_transformer_ms_a_batch():
    read = _reader("transformer_ms.sepformer")
    host = [("sst.sepformer.intra", 10, 13), ("sst.sepformer.inter", 13, 18),
            ("sst.sepformer.intra", 30, 32), ("sst.sepformer.segment", 1, 2),
            ("sst.sepformer.merge", 40, 50), ("sst.dprnn.intra", 60, 70)]
    assert read(_window(_trace([1.0], host=host))) == pytest.approx(5.0)  # (3 + 5 + 2) / 2 items
    assert read(_window(_trace([1.0], host=[("sst.dprnn.inter", 1, 2)]))) is None
    assert read(_window(None)) is None


def test_flops_a_frame_by_hand():
    # a layer's Linears a token: 256 x 768 + 256 x 256 + 2 x 256 x 1,024; intra attention
    # 4 x 250 x 256 (multiply-adds counted twice below, so half of it here)
    layer = 256 * 768 + 256 * 256 + 2 * 256 * 1024
    block = 8 * (2 * layer + 2 * 250 * 256)
    total = (16 * 256 + 256 * 256 + 2 * (2 * block + 256 * 512)
             + 2 * (2 * 256 * 256 + 256 * 256) + 2 * 256 * 16)
    assert _reference().flops_per_frame(_cfg()) == 2 * total == 110_321_664
    # inter attention at 10 s, left out: 4 x 81 x 256 a chunk frame on 2 chunk frames, 16 layers
    inter = 2 * 16 * 4 * 81 * 256
    assert 0.023 < inter / (2 * total + inter) < 0.025


def test_parameter_count_and_widths_match_the_paper():
    cfg = _cfg()
    keys = ("enc_dim", "win", "d_model", "heads", "ffn", "layers", "chunk", "blocks", "num_speakers")
    assert tuple(cfg[k] for k in keys) == (256, 16, 256, 8, 1024, 8, 250, 2, 2)
    shapes = _reference().param_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == cfg["parameters"] == 25_679_361
    assert round(cfg["parameters"] / 1e5) == 257  # SpeechBrain's 25.7M
    assert cfg["reduced"] == [] and cfg["precision"] == "bf16" and cfg["control_precision"] == "fp8"


def test_the_cell_reports_its_metrics():
    cell = harness.Cell.find("sepformer_separate")
    assert {m["name"] for m in cell.per_layer} == {
        "attention_roofline.sepformer", "transformer_ms.sepformer", "device_idle.separate",
        "mfu.separate"}
    assert {m["name"] for m in cell.end_to_end} == {"separate_rtf", "setup_s"}
    assert cell.chips == 1 and cell.traffic["batch"] == 16
    assert (ROOT / "bench_torch" / "limits" / "sepformer_separate.json").is_file()


@pytest.mark.parametrize("mode,fault", [("control", None), ("program", "answer_altered"),
                                        ("program", "half_batch")])
def test_control_and_faults_come_out_not_correct(mode, fault, cpu):
    """As ``test_checks.py`` holds the other cells: the reference in fp8 in
    the program's place, and each fault planted in the timed path."""
    cell = tiny_cell("sepformer_separate")
    assert cell.limits
    result = harness.run_cell(cell, 2**31 + 29, 0.3, False, t_start=time.perf_counter(), device=cpu,
                              mode=mode, fault=fault)
    assert result["correct"] is False, result["checks"]
    assert all(math.isfinite(c["value"]) for c in result["checks"].values())
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
