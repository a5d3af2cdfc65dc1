"""The serving LSTM recurrence (``lstm_fwd_persistent_kernel`` not in
training mode, kernel table row 2): Σ bound / Σ device time over its
launches, in %. A layer's launch covers both directions and at most 256
rows; its steps are the batch's padded STFT frames."""

from bench_torch.counts import lstm_serving_bound_s, row_slices
from bench_torch.readers import instance_of, roofline_percent


def read(w):
    cfg = w.cfg
    size, shift = cfg["stft_size"], cfg["stft_shift"]

    def launches(it):
        steps = -(-(it["samples"] + size - shift) // shift)
        slices = row_slices(it["rows"])
        bound = sum(lstm_serving_bound_s(r, steps, cfg["hidden"]) for r in slices)
        return cfg["num_layers"] * len(slices), cfg["num_layers"] * bound

    serving = instance_of("lstm_fwd_persistent_kernel", lambda a: a[1] == "false")
    return roofline_percent(w, serving, launches)
