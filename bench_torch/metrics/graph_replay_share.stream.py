"""Share of the window's ``cuda_apply`` calls, in %, that replayed a CUDA
graph of the hop (``models/tasnet_serving.py::cuda_apply``): the port's
``sst.tasnet.graph.replay`` spans over its ``sst.tasnet.weights`` spans. A
program that looks its weights up and launches every kernel itself reads 0;
nothing where the run is untraced or the program records no
``sst.tasnet.weights``."""

from bench_torch import trace as tr


def read(w):
    if w.trace is None:
        return None
    calls = tr.host_events(w.trace, "sst.tasnet.weights")
    if not calls:
        return None
    return 100.0 * len(tr.host_events(w.trace, "sst.tasnet.graph.replay")) / len(calls)
