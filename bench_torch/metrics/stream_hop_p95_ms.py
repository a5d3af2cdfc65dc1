"""The 95th percentile, over every hop of the window, of the host's time
from ``push`` to the hop's estimate back on the host, in ms."""

from bench_torch.stats import percentile


def read(w):
    return 1e3 * percentile([it["latency_s"] for it in w.items], 95)
