"""The share of the traced window in which no kernel, copy or memset ran on
the device, in %."""

from bench_torch.readers import idle_percent


def read(w):
    return idle_percent(w)
