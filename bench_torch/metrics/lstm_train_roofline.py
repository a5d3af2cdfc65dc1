"""The training LSTM kernels taken together (kernel table rows 3 and 4: the
training-mode ``lstm_fwd_persistent_kernel`` and
``lstm_bwd_persistent_kernel``): Σ bound / Σ device time over their
launches, in %. Each layer makes one forward launch a slice of at most 256
rows and one backward launch; the steps are the batch's padded STFT frames."""

from bench_torch.counts import lstm_train_bound_s, row_slices
from bench_torch.readers import instance_of, roofline_percent


def read(w):
    cfg = w.cfg
    size, shift, hidden, layers = cfg["stft_size"], cfg["stft_shift"], cfg["hidden"], cfg["num_layers"]

    def launches(it):
        steps = -(-(it["samples"] + size - shift) // shift)
        slices = row_slices(it["rows"])
        bound = (sum(lstm_train_bound_s("forward", r, steps, hidden) for r in slices)
                 + lstm_train_bound_s("backward", it["rows"], steps, hidden))
        return layers * (len(slices) + 1), layers * bound

    forward = instance_of("lstm_fwd_persistent_kernel", lambda a: a[1] == "true")
    backward = instance_of("lstm_bwd_persistent_kernel")
    return roofline_percent(w, lambda e: forward(e) or backward(e), launches)
