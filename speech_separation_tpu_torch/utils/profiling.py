"""Run metrics as JSON lines (counterpart of ``utils/profiling.MetricsLogger``),
the port's named spans in a ``torch.profiler`` trace (:func:`span`), and the
device time of the spans that record it (:func:`device_ms`)."""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch

__all__ = ["MetricsLogger", "clear_device_spans", "device_ms", "span"]

SPAN_PREFIX = "sst."
_OFF = contextlib.nullcontext()  # stateless: one instance serves every span not recorded


class MetricsLogger:
    """Appends one JSON object per :meth:`log` call to ``path``: ``step``,
    ``wall_s`` since construction, and the given metrics."""

    def __init__(self, path: str | pathlib.Path):
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()
        self._handle = open(path, "a")

    def log(self, step: int, **metrics: float) -> None:
        record = {"step": step, "wall_s": round(time.time() - self._t0, 3), **metrics}
        self._handle.write(json.dumps(record) + "\n")
        self._handle.flush()

    def close(self) -> None:
        self._handle.close()


def span(name: str, *, device: bool = False):
    """A host span ``sst.<name>`` around a ``with`` block, recorded in the
    trace of a running ``torch.profiler`` on its clock, beside the device
    activity; with no profiler recording, a shared no-op context (no
    profiler object is built, ``device`` or not). The span is a plain
    function event, host side only: it encloses the launches made in the
    block, not their device time.

    With ``device``, a recorded span also brackets its block with two timing
    events on the current CUDA stream and keeps the pair in memory for
    :func:`device_ms`: the device time of the work queued in the block. Where
    CUDA is not initialised, or the current stream is capturing a graph, the
    span is the host event alone."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    # not record_function: on CUDA its user annotation gets a GPU-side mirror, read as a kernel
    from torch._C._profiler import _RecordFunctionFast

    name = SPAN_PREFIX + name
    host = _RecordFunctionFast(name)
    if device and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
        return _DeviceSpan(host, name)
    return host


# every device span recorded since the last clear_device_spans: [name, start, end], in the
# order they opened (end None while the span is open)
_DEVICE_SPANS: list[list] = []


class _DeviceSpan:
    """A host span whose block is also bracketed by two CUDA timing events,
    both on the stream current when it opens."""

    __slots__ = ("_host", "_pair", "_stream", "_end")

    def __init__(self, host, name: str):
        self._host = host
        self._pair = [name, None, None]

    def __enter__(self):
        self._host.__enter__()
        self._stream = stream = torch.cuda.current_stream()
        start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        # an event's CUDA handle is made at its first record: made here, the end's
        # creation stays out of the interval it closes (its last record counts)
        self._end.record(stream)
        start.record(stream)
        self._pair[1] = start
        _DEVICE_SPANS.append(self._pair)
        return self

    def __exit__(self, *exc):
        self._end.record(self._stream)
        self._pair[2] = self._end
        return self._host.__exit__(*exc)


def device_ms(name: str) -> list[float]:
    """The device milliseconds of each span called ``name`` (as the trace
    names it, ``sst.<name>``) recorded with ``device=True`` since the last
    :func:`clear_device_spans`, in the order they opened, those still open
    left out; waits for each pair's end event."""
    times = []
    for span_name, start, end in _DEVICE_SPANS:
        if span_name == name and end is not None:
            end.synchronize()
            times.append(start.elapsed_time(end))
    return times


def clear_device_spans() -> None:
    """Forget every device span recorded so far."""
    _DEVICE_SPANS.clear()
