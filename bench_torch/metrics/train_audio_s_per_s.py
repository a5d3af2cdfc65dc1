"""True seconds of audio trained in the window's steps, a second of its wall
time, which ends in a synchronise."""

from bench_torch.readers import audio_rate


def read(w):
    return audio_rate(w)
