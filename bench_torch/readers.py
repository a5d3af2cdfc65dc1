"""What the metric readers (``metrics/<name>.py``) share. A reader takes
the :class:`Window` of a run and returns its number, or ``None`` where the
run has nothing for it to read (a per-layer metric in an untraced run, or a
kernel that never ran)."""

from __future__ import annotations

import re
from dataclasses import dataclass

from bench_torch import trace as tr


@dataclass
class Window:
    cfg: dict
    seconds: float  # the measured window, host clock
    items: list[dict]  # one a batch, step or hop
    setup_s: float
    flops_per_frame: int
    peak_flops: float  # the configuration's peak, FLOP/s
    trace: tr.Trace | None = None


def audio_rate(w: Window) -> float:
    """True audio seconds of the window's completed work a second of it."""
    return sum(it["audio_s"] for it in w.items) / w.seconds


def idle_percent(w: Window) -> float | None:
    return None if w.trace is None else 100.0 * tr.idle_share(w.trace)


def mfu_percent(w: Window, passes: float) -> float | None:
    """The model's products over the true frames (times ``passes``: 3 for a
    training step's forward and backward) a second of the traced window, as
    a share of the configuration's peak."""
    if w.trace is None:
        return None
    flops = passes * w.flops_per_frame * sum(it["frames"] for it in w.items)
    return 100.0 * flops / w.seconds / w.peak_flops


def template_args(name: str, kernel: str) -> list[str] | None:
    """The template arguments of a device kernel's demangled name, or
    ``None`` where ``name`` is not an instance of ``kernel``."""
    m = re.search(re.escape(kernel) + r"<([^<>]*)>", name)
    return None if m is None else [a.strip() for a in m.group(1).split(",")]


def instance_of(kernel: str, accept=lambda args: True):
    """A predicate on device events: an instance of ``kernel`` whose
    template arguments ``accept`` takes."""
    def match(e) -> bool:
        args = template_args(e.name, kernel)
        return args is not None and accept(args)

    return match


def roofline_percent(w: Window, match, launches_and_bound) -> float | None:
    """Σ bound / Σ device time over the window's device events that
    ``match`` takes; ``launches_and_bound(item)`` gives an item's expected
    launches and their summed bound in seconds. ``None`` where no such
    launch ran, or where their count is not the expected one (the bound
    would belong to other launches)."""
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, match)
    if not events:
        return None
    expected, bound = 0, 0.0
    for it in w.items:
        n, b = launches_and_bound(it)
        expected += n
        bound += b
    if len(events) != expected:
        return None
    return 100.0 * bound / (sum(e.end - e.start for e in events) / 1e9)


def device_ms_per_item(w: Window, predicate) -> float | None:
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, predicate)
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)


def host_ms_per_item(w: Window, name: str) -> float | None:
    if w.trace is None:
        return None
    events = tr.host_events(w.trace, name)
    if not events:
        return None
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)


def device_ops_per_item(w: Window) -> float | None:
    if w.trace is None:
        return None
    return len(tr.device_events(w.trace)) / len(w.items)
