"""Run metrics as JSON lines (counterpart of ``utils/profiling.MetricsLogger``),
and the port's named spans in a ``torch.profiler`` trace (:func:`span`)."""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

import torch

__all__ = ["MetricsLogger", "span"]

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


def span(name: str):
    """A host span ``sst.<name>`` around a ``with`` block, recorded in the
    trace of a running ``torch.profiler`` on its clock, beside the device
    activity; with no profiler recording, a shared no-op context (no
    profiler object is built). The span is a plain function event, host side
    only: it encloses the launches made in the block, not their device time."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    # not record_function: on CUDA its user annotation gets a GPU-side mirror, read as a kernel
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(SPAN_PREFIX + name)
