"""The reader of ``d2h_pinned_share.separate``: the device time of the
window's pinned device-to-host copies over that of all of them, in %, on
synthetic traces; nothing untraced or without such a copy."""

import importlib.util

import pytest

from bench_torch import harness
from bench_torch import trace as tr
from bench_torch.readers import Window

METRIC = "d2h_pinned_share.separate"
PAGEABLE, PINNED = "Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pinned)"
MS = 1_000_000  # ns


def _read(trace):
    path = harness.HERE / "metrics" / f"{METRIC}.py"
    spec = importlib.util.spec_from_file_location("reader_d2h_pinned_share", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(Window({}, 1.0, [{}] * 4, 0.0, 1, 1.0, trace))


def _trace(copies) -> tr.Trace:
    """A window of 100 ms: a kernel, a pinned host-to-device copy, the
    ``(name, ms)`` copies back one after another, and one pageable copy
    back after the window."""
    ev = tr.Event
    device = [ev("void k<1>(P)", 0, 5 * MS, "kernel"),
              ev("Memcpy HtoD (Pinned -> Device)", 5 * MS, 6 * MS, "gpu_memcpy")]
    start = 10 * MS
    for name, ms in copies:
        device.append(ev(name, start, start + ms * MS, "gpu_memcpy"))
        start += ms * MS + MS
    device.append(ev(PAGEABLE, 120 * MS, 150 * MS, "gpu_memcpy"))
    host = [ev("bench.window", 0, 100 * MS, "user_annotation")]
    return tr.Trace(device, host, 0, 100 * MS)


@pytest.mark.parametrize("copies, share", [
    ([(PAGEABLE, 20), (PAGEABLE, 30)], 0.0),
    ([(PINNED, 3), (PINNED, 4)], 100.0),
    ([(PAGEABLE, 30), (PINNED, 10)], 25.0),
])
def test_pinned_device_time_over_all_copies_back(copies, share):
    assert _read(_trace(copies)) == pytest.approx(share)


def test_nothing_untraced_or_without_a_copy_back():
    assert _read(None) is None
    assert _read(_trace([])) is None
