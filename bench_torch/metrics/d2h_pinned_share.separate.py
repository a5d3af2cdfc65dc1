"""Share of the device time of the window's device-to-host copies that
landed in page-locked memory (``Memcpy DtoH (Device -> Pinned)``), in %:
the estimates' copy back. 0 where they come back through a pageable
``.cpu()``; nothing where the window copied nothing to the host."""

from bench_torch import trace as tr


def read(w):
    if w.trace is None:
        return None
    d2h = tr.device_events(w.trace, lambda e: e.kind == "gpu_memcpy" and "DtoH" in e.name)
    total = sum(e.end - e.start for e in d2h)
    if not total:
        return None
    pinned = sum(e.end - e.start for e in d2h if "Pinned" in e.name)
    return 100.0 * pinned / total
