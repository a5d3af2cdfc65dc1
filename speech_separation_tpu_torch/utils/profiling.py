"""Run metrics as JSON lines (counterpart of ``utils/profiling.MetricsLogger``)."""

from __future__ import annotations

import json
import pathlib
import time

__all__ = ["MetricsLogger"]


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
