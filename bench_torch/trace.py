"""The traced window: ``torch.profiler`` over the measured loop, reduced to
plain event lists that the per-layer readers work on.

Busy time is the union of the intervals in which a kernel, a copy or a
memset ran on the device (``scripts/torch_profile_*.py``'s method, with
overlaps counted once); the GPU spans of user annotations are left out, as
they enclose the kernels they annotate. The window is the harness's own
``bench.window`` span, on the profiler's clock.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 120  # a breakdown's names are cut to this many characters


@dataclass
class Event:
    name: str
    start: int  # ns, profiler clock
    end: int
    kind: str  # the profiler's activity type
    thread: int = 0


@dataclass
class Trace:
    device: list[Event]
    host: list[Event]
    start: int  # the window, ns
    end: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9


@dataclass
class Capture:
    trace: Trace | None = None


def span(name: str, enabled: bool):
    """A named host span in the trace (``bench.<name>``), or nothing when not tracing."""
    return torch.profiler.record_function(SPAN_PREFIX + name) if enabled else contextlib.nullcontext()


@contextlib.contextmanager
def record(enabled: bool):
    """Profile the block (CPU and CUDA activity) when ``enabled``; the
    yielded :class:`Capture` holds the reduced trace afterwards."""
    capture = Capture()
    if not enabled:
        yield capture
        return
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        yield capture
    capture.trace = reduce(prof.profiler.kineto_results.events())


# GPU spans of host annotations (the harness's own, torch's optimizer
# spans) are named as the host spans they mirror
ANNOTATIONS = (SPAN_PREFIX, "Optimizer.", "ProfilerStep")


def _activity(event, on_device: bool) -> str:
    """The event's activity type as the profiler's trace names it, worked out
    from where it ran, whether it annotates, and its name (the raw events of
    torch's kineto results carry no type)."""
    annotation = event.is_user_annotation()
    name = event.name()
    if not on_device:
        return "user_annotation" if annotation else "cpu_op"
    if annotation or name.startswith(ANNOTATIONS):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def reduce(raw) -> Trace:
    """Plain device and host event lists from the profiler's raw events."""
    device, host = [], []
    window = None
    for e in raw:
        start = e.start_ns()
        on_device = e.device_type() == torch.autograd.DeviceType.CUDA
        ev = Event(e.name(), start, start + e.duration_ns(), _activity(e, on_device),
                   e.start_thread_id())
        if on_device:
            if ev.kind in DEVICE_ACTIVITIES:
                device.append(ev)
        else:
            host.append(ev)
            if ev.name == WINDOW_SPAN:
                window = ev
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    window_thread = window.thread
    host = [ev for ev in host if ev.thread == window_thread]
    return Trace(device, host, window.start, window.end)


def busy_intervals(trace: Trace) -> list[tuple[int, int]]:
    """The union of the device's busy intervals inside the window, sorted."""
    spans = sorted((max(e.start, trace.start), min(e.end, trace.end)) for e in trace.device
                   if e.end > trace.start and e.start < trace.end)
    merged: list[list[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e9


def idle_share(trace: Trace) -> float:
    """The share of the window in which nothing ran on the device, 0 to 1."""
    return 1.0 - busy_s(trace) / trace.window_s


def device_events(trace: Trace, predicate=lambda e: True) -> list[Event]:
    """The window's device events that ``predicate`` accepts."""
    return [e for e in trace.device if e.start >= trace.start and e.end <= trace.end and predicate(e)]


def host_events(trace: Trace, name: str) -> list[Event]:
    """The window's host events called ``name``."""
    return [e for e in trace.host if e.name == name and e.start >= trace.start and e.end <= trace.end]


def device_ops(trace: Trace, top: int = 10) -> list[list]:
    """``[[name, seconds], ...]``: the device operations that took most time."""
    by_name: dict[str, int] = {}
    for e in device_events(trace):
        key = e.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0) + (e.end - e.start)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return [[name, ns / 1e9] for name, ns in ranked]


def _host_label(trace: Trace, at: int) -> str:
    """What the host was doing at ``at``: the innermost harness span and the
    innermost host event around it."""
    covering = [e for e in trace.host if e.start <= at < e.end and e.name != WINDOW_SPAN]
    spans = [e for e in covering if e.name.startswith(SPAN_PREFIX)]
    inner = min(covering, key=lambda e: e.end - e.start, default=None)
    outer = min(spans, key=lambda e: e.end - e.start, default=None)
    parts = [e.name for e in (outer, inner) if e is not None]
    if len(parts) == 2 and parts[0] == parts[1]:
        parts = parts[:1]
    return (" / ".join(parts) or "no host event")[:NAME_CHARS]


def idle_gaps(trace: Trace, top: int = 10) -> list[list]:
    """``[[label, seconds], ...]``: the longest idle gaps of the window, each
    labelled by what the host was doing at its middle."""
    gaps, last = [], trace.start
    for s, e in busy_intervals(trace):
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if trace.end > last:
        gaps.append((last, trace.end))
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[_host_label(trace, (s + e) // 2), (e - s) / 1e9] for s, e in gaps[:top]]
