"""Host ms a batch inside TF-GridNet's block spans, ``sst.tfgridnet.intra``,
``.inter`` and ``.attention`` (``models/tfgridnet.py``, one of each a block a
forward): the launches of the BiLSTMs, transposed convs, attention and
norms, and whatever waits the host meets there. None where no span was
recorded."""

from bench_torch import trace as tr

SPANS = ("sst.tfgridnet.intra", "sst.tfgridnet.inter", "sst.tfgridnet.attention")


def read(w):
    if w.trace is None:
        return None
    events = [e for name in SPANS for e in tr.host_events(w.trace, name)]
    if not events:
        return None
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)
