"""The readers of ``norm_ms.sepformer`` and ``fused_norm_share.sepformer``
on synthetic traces: device ms a batch in the launches whose kernel names
hold ``layer_norm``, and the fused kernel's share of those launches;
nothing untraced or without such a launch."""

import importlib.util

import pytest

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window

TORCH_LN = ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, "
            "false>(int, float, float const*, float const*, float const*, float*, float*, float*)")
FUSED_LN = ("void (anonymous namespace)::residual_layer_norm_kernel<4, 2>(float*, void const*, "
            "float const*, float const*, void*, int, int, int, int)")
ADD = "void at::native::unrolled_elementwise_kernel<at::native::CUDAFunctor_add<float>>(int)"
MS = 1_000_000  # ns
BATCHES = 4


def _read(metric, trace):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(Window({}, 1.0, [{}] * BATCHES, 0.0, 1, 1.0, trace))


def _trace(launches) -> tr.Trace:
    """A window of 100 ms: a GEMM, the ``(name, ms)`` launches one after
    another with an elementwise add between each two, and one LayerNorm
    launch after the window."""
    ev = tr.Event
    device = [ev("nvjet_tst_128x288_64x4_2x1_v_bz_coopA_bias_NNT", 0, 5 * MS, "kernel")]
    start = 10 * MS
    for name, ms in launches:
        device.append(ev(name, start, start + ms * MS, "kernel"))
        device.append(ev(ADD, start + ms * MS, start + ms * MS + MS // 2, "kernel"))
        start += ms * MS + MS
    device.append(ev(TORCH_LN, 120 * MS, 150 * MS, "kernel"))
    host = [ev("bench.window", 0, 100 * MS, "user_annotation")]
    return tr.Trace(device, host, 0, 100 * MS)


@pytest.mark.parametrize("launches, norm_ms, share", [
    ([(TORCH_LN, 2), (TORCH_LN, 3), (TORCH_LN, 3)], 8 / BATCHES, 0.0),
    ([(FUSED_LN, 1), (FUSED_LN, 2)], 3 / BATCHES, 100.0),
    ([(TORCH_LN, 6), (FUSED_LN, 1), (FUSED_LN, 1), (FUSED_LN, 2)], 10 / BATCHES, 75.0),
])
def test_layer_norm_ms_a_batch_and_the_fused_share(launches, norm_ms, share):
    trace = _trace(launches)
    assert _read("norm_ms.sepformer", trace) == pytest.approx(norm_ms)
    assert _read("fused_norm_share.sepformer", trace) == pytest.approx(share)


@pytest.mark.parametrize("metric", ["norm_ms.sepformer", "fused_norm_share.sepformer"])
def test_nothing_untraced_or_without_a_layer_norm_launch(metric):
    assert _read(metric, None) is None
    assert _read(metric, _trace([])) is None
