"""The serving LSTM recurrence (``lstm_fwd_persistent_kernel`` not in training
mode, kernel table row 2): Σ bound / Σ device time over its launches in the
window, in %. The bound is counted from each batch's work by the
configuration's own counts module (``counts_<arch>.recurrence_bound_s``; for
TF-GridNet B·T rows of F − 3 steps and B·F rows of T − 3 at H = 256), not
from the launches' row slices, so the reader names no model. None where no
launch ran."""

import importlib

from bench_torch import trace as tr
from bench_torch.counts_dprnn import SERVING_LSTM


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, SERVING_LSTM)
    if not events:
        return None
    counts = importlib.import_module(f"bench_torch.counts_{w.cfg['arch']}")
    bound = sum(counts.recurrence_bound_s(w.cfg, it["rows"], it["samples"]) for it in w.items)
    return 100.0 * bound / (sum(e.end - e.start for e in events) / 1e9)
