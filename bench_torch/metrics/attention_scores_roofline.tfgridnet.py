"""TF-GridNet's attention-scores kernel (``csrc/wide_attention.cu``, heads of
E·F = 516): Σ bound / Σ device time over its launches in the window, in %.
The bound is counted from each batch's work (``counts_tfgridnet.scores_bound_s``),
not from the launches. None where no launch ran."""

from bench_torch import trace as tr
from bench_torch.counts_tfgridnet import is_scores, scores_bound_s


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, is_scores)
    if not events:
        return None
    bound = sum(scores_bound_s(w.cfg, it["rows"], it["samples"]) for it in w.items)
    return 100.0 * bound / (sum(e.end - e.start for e in events) / 1e9)
