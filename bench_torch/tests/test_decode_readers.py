"""The readers of ``decode_ms.stream`` and ``fused_decode_share.stream`` on
synthetic traces: device ms a hop in the decoder's launches (kernel names
holding ``dgrad`` or ``mask_decode``), and the fused kernel's share of those
launches; nothing untraced or without such a launch."""

import importlib.util

import pytest

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window

DGRAD = ("void cudnn::cnn::dgrad2d_grouped_direct_kernel<__nv_bfloat16, float, float, float, "
         "true, false, 0, 0, 0>(cudnnTensorStruct, __nv_bfloat16 const*, cudnnFilterStruct, "
         "__nv_bfloat16 const*, cudnnConvolutionStruct, cudnnTensorStruct, __nv_bfloat16*, float, "
         "float, cudnn::reduced_divisor, int)")
FUSED = ("(anonymous namespace)::mask_decode_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, "
         "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, float*, int, int, int, "
         "int, int, int, int)")
TRUNK = "void (anonymous namespace)::trunk_kernel<false, 3>((anonymous namespace)::TrunkArgs)"
SIGMOID = "void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda>(int)"
MS = 1_000_000  # ns
HOPS = 4


def _read(metric, trace):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(Window({}, 1.0, [{}] * HOPS, 0.0, 1, 1.0, trace))


def _trace(launches) -> tr.Trace:
    """A window of 100 ms: a trunk launch, the ``(name, ms)`` launches one
    after another with a sigmoid between each two, and one dgrad launch after
    the window."""
    ev = tr.Event
    device = [ev(TRUNK, 0, 5 * MS, "kernel")]
    start = 10 * MS
    for name, ms in launches:
        device.append(ev(name, start, start + ms * MS, "kernel"))
        device.append(ev(SIGMOID, start + ms * MS, start + ms * MS + MS // 2, "kernel"))
        start += ms * MS + MS
    device.append(ev(DGRAD, 120 * MS, 150 * MS, "kernel"))
    host = [ev("bench.window", 0, 100 * MS, "user_annotation")]
    return tr.Trace(device, host, 0, 100 * MS)


@pytest.mark.parametrize("launches, decode_ms, share", [
    ([(DGRAD, 2), (DGRAD, 3), (DGRAD, 1), (DGRAD, 2)], 8 / HOPS, 0.0),
    ([(FUSED, 1), (FUSED, 1), (FUSED, 2), (FUSED, 1)], 5 / HOPS, 100.0),
    ([(DGRAD, 6), (FUSED, 1), (FUSED, 1), (FUSED, 2)], 10 / HOPS, 75.0),
], ids=["cudnn_only", "fused_only", "mixed"])
def test_decoder_ms_a_hop_and_the_fused_share(launches, decode_ms, share):
    trace = _trace(launches)
    assert _read("decode_ms.stream", trace) == pytest.approx(decode_ms)
    assert _read("fused_decode_share.stream", trace) == pytest.approx(share)


@pytest.mark.parametrize("metric", ["decode_ms.stream", "fused_decode_share.stream"])
def test_nothing_untraced_or_without_a_decoder_launch(metric):
    assert _read(metric, None) is None
    assert _read(metric, _trace([])) is None


@pytest.mark.parametrize("metric", ["decode_ms.stream", "fused_decode_share.stream"])
def test_the_metric_is_the_stream_cells(metric):
    m = next(x for x in harness.load_benchmark()["per_layer"] if x["name"] == metric)
    assert (m["layer"], m["moves"], m["workloads"]) == ("streaming engine", "stream_hop_p95_ms",
                                                       ["tasnet_stream"])
    assert metric in {x["name"] for x in harness.Cell.find("tasnet_stream").per_layer}
