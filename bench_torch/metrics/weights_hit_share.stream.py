"""Share of the window's ``cuda_apply`` calls, in %, whose weights came from
the port's cache (``models/tasnet_serving.py::_serving``): the port's
``sst.tasnet.weights.hit`` spans over its ``sst.tasnet.weights`` spans. A
program that restacks every call records no hit and reads 0; nothing where
the run is untraced or the program records no ``sst.tasnet.weights``."""

from bench_torch import trace as tr


def read(w):
    if w.trace is None:
        return None
    calls = tr.host_events(w.trace, "sst.tasnet.weights")
    if not calls:
        return None
    return 100.0 * len(tr.host_events(w.trace, "sst.tasnet.weights.hit")) / len(calls)
