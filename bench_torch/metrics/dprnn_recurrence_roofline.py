"""The serving LSTM recurrence in the dual-path blocks (``lstm_fwd_persistent_kernel``
not in training mode, kernel table row 2 at H = 128): Σ bound / Σ device
time over its launches in the window, in %. The bound is counted from each
batch's work (``counts_dprnn.dual_path_bound_s``), not from the program's
row slices, so a plan that launches differently is read against the same
yardstick. None where no launch ran."""

from bench_torch import trace as tr
from bench_torch.counts_dprnn import SERVING_LSTM, dual_path_bound_s


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, SERVING_LSTM)
    if not events:
        return None
    bound = sum(dual_path_bound_s(w.cfg, it["rows"], it["samples"]) for it in w.items)
    return 100.0 * bound / (sum(e.end - e.start for e in events) / 1e9)
