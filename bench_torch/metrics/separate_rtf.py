"""True (unpadded) seconds of mixture separated in the window, a second of
its wall time: each batch host → device → estimates back on the host."""

from bench_torch.readers import audio_rate


def read(w):
    return audio_rate(w)
