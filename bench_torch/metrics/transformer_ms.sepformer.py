"""Host ms a batch inside the port's dual-path transformer spans,
``sst.sepformer.intra`` and ``sst.sepformer.inter`` (``models/sepformer.py``
through ``models/dprnn.py::_DualPathBlock``, one of each a block a forward):
the launches of the transformer layers, the norms and the residuals, and
whatever waits the host meets there. None where neither span was recorded."""

from bench_torch import trace as tr

SPANS = ("sst.sepformer.intra", "sst.sepformer.inter")


def read(w):
    if w.trace is None:
        return None
    events = [e for name in SPANS for e in tr.host_events(w.trace, name)]
    if not events:
        return None
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)
