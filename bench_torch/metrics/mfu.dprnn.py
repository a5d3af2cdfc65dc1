"""The model's products over the true frames separated in the traced
window, a second, as a share of the configuration's peak, in %."""

from bench_torch.readers import mfu_percent


def read(w):
    return mfu_percent(w, 1)
