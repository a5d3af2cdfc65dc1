"""The attention of the dual-path transformer (SDPA's flash kernel): Σ
bound / Σ device time over its launches in the window, in %. The bound is
counted from each batch's work (``counts_sepformer.attention_bound_s``), not
from the backend's launches, so a backend that splits the work otherwise is
read against the same yardstick. None where no launch ran."""

from bench_torch import trace as tr
from bench_torch.counts_sepformer import attention_bound_s, is_attention


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, is_attention)
    if not events:
        return None
    bound = sum(attention_bound_s(w.cfg, it["rows"], it["samples"]) for it in w.items)
    return 100.0 * bound / (sum(e.end - e.start for e in events) / 1e9)
