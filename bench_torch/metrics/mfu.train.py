"""Three times the model's forward products over the true frames trained in
the traced window (forward and backward), a second, as a share of the
configuration's peak, in %."""

from bench_torch.readers import mfu_percent


def read(w):
    return mfu_percent(w, 3)
