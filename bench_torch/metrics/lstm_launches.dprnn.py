"""Launches of the serving LSTM recurrence (kernel table row 2) a batch in
the traced window: a counter of the row-slice serialisation (the forward
plan launches at most 256 rows at a time, one slice after another). None
where no launch ran."""

from bench_torch import trace as tr
from bench_torch.counts_dprnn import SERVING_LSTM


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, SERVING_LSTM)
    return float(len(events)) / len(w.items) if events else None
