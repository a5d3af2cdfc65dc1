"""The reduction of a trace: busy time as a union, idle gaps with their
host labels, rooflines only where every launch is accounted for."""

import pytest
import torch

from bench_torch import trace as tr
from bench_torch.readers import Window, instance_of, roofline_percent, template_args


def _trace():
    ev = tr.Event
    device = [ev("void k<false, 2>(P)", 100, 300, "kernel"), ev("void k<false, 2>(P)", 200, 400, "kernel"),
              ev("Memcpy HtoD (Pinned -> Device)", 600, 700, "gpu_memcpy"),
              ev("void k<true, 2>(P)", 900, 950, "kernel")]
    host = [ev("bench.window", 0, 1000, "user_annotation"), ev("bench.fetch", 400, 600, "user_annotation"),
            ev("aten::copy_", 450, 550, "cpu_op"), ev("bench.separate", 700, 900, "user_annotation")]
    return tr.Trace(device, host, 0, 1000)


def test_busy_is_the_union_and_idle_the_rest():
    t = _trace()
    assert tr.busy_intervals(t) == [(100, 400), (600, 700), (900, 950)]
    assert tr.busy_s(t) == pytest.approx(450e-9)
    assert tr.idle_share(t) == pytest.approx(0.55)


def test_idle_gaps_labelled_by_the_host():
    gaps = tr.idle_gaps(_trace(), top=2)
    assert gaps[0] == ["bench.fetch / aten::copy_", pytest.approx(200e-9)]
    assert gaps[1] == ["bench.separate", pytest.approx(200e-9)]


def test_device_ops_ranked():
    ops = tr.device_ops(_trace())
    assert ops[0] == ["void k<false, 2>(P)", pytest.approx(400e-9)]


def test_template_args():
    assert template_args("void lstm_fwd_persistent_kernel<float, true, false, true, 2>(float const*)",
                         "lstm_fwd_persistent_kernel") == ["float", "true", "false", "true", "2"]
    assert template_args("void other_kernel<1>(int)", "lstm_fwd_persistent_kernel") is None


def test_roofline_needs_every_launch():
    w = Window({}, 1.0, [{"rows": 1}, {"rows": 1}], 0.0, 1, 1.0, _trace())
    match = instance_of("k", lambda a: a[0] == "false")
    # two launches of 200 ns each, bound 100 ns each: 50%
    assert roofline_percent(w, match, lambda it: (1, 100e-9)) == pytest.approx(50.0)
    assert roofline_percent(w, match, lambda it: (2, 100e-9)) is None  # a launch unaccounted
    untraced = Window({}, 1.0, [], 0.0, 1, 1.0, None)
    assert roofline_percent(untraced, match, lambda it: (1, 1.0)) is None


class _Raw:
    """A raw profiler event as torch's kineto results give it."""

    def __init__(self, name, start, dur, on_device=False, thread=1, annotation=False):
        self._name, self._start, self._dur = name, start, dur
        self._device, self._thread, self._annotation = on_device, thread, annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._device else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation


def test_reduce_sorts_device_activity_from_annotations_and_other_threads():
    raw = [_Raw("bench.window", 0, 1000, annotation=True),
           _Raw("aten::mm", 100, 50),
           _Raw("aten::copy_", 200, 50, thread=2),  # the feed's thread
           _Raw("bench.window", 90, 900, on_device=True),  # the window's GPU span
           _Raw("Optimizer.step#Adam.step", 300, 10, on_device=True),
           _Raw("void gemm<float>(P)", 110, 40, on_device=True),
           _Raw("Memcpy DtoH (Device -> Pageable)", 400, 20, on_device=True),
           _Raw("Memset (Device)", 500, 5, on_device=True)]
    t = tr.reduce(raw)
    assert (t.start, t.end) == (0, 1000)
    assert [(e.name, e.kind) for e in t.device] == [
        ("void gemm<float>(P)", "kernel"), ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
        ("Memset (Device)", "gpu_memset")]
    assert [(e.name, e.kind) for e in t.host] == [("bench.window", "user_annotation"),
                                                  ("aten::mm", "cpu_op")]
    with pytest.raises(RuntimeError):
        tr.reduce(raw[1:])


def test_reduce_reads_a_profiler_capture():
    with tr.record(True) as capture:
        with tr.span("window", True):
            with tr.span("step", True):
                torch.ones(64).sum()
    t = capture.trace
    assert t.window_s > 0 and t.device == []
    kinds = {e.name: e.kind for e in t.host}
    assert kinds["bench.step"] == "user_annotation" and kinds["aten::sum"] == "cpu_op"
    assert all(t.start <= e.start and e.end <= t.end for e in t.host if e.name != "bench.window")
