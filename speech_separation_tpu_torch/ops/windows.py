"""Analysis / synthesis window construction (host-side, float64).

A numpy copy of ``speech_separation_tpu/ops/windows.py``, so the port needs
no JAX. Windows are tiny (<= a few thousand samples) and are precomputed once
on the host in float64 for numerical fidelity, then cast and moved to the
device by their callers.

Reference semantics: the analysis window is the symmetric Blackman window
(`scipy.signal.blackman`, see reference `parallel_stft.py:146-147`), and the
synthesis window is the biorthogonal dual window of Krueger eq. A.92
(reference `uPIT_baseline.ipynb cell 38`), including the reference's two
idiosyncrasies which we reproduce bit-for-bit because committed golden wavs
depend on them:

1. the sum-of-squares accumulation skips analysis index ``fft_size - 1``
   (the ``analysis_index + 1 < fft_size`` guard);
2. the ``1 / fft_size`` normalisation is cancelled by a later ``*= size``
   (so the net synthesis window is ``analysis / sum_of_squares``).
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["blackman", "biorthogonal_synthesis_window", "analysis_window"]


def blackman(length: int) -> np.ndarray:
    """Symmetric Blackman window, identical to numpy/scipy ``blackman``."""
    if length == 1:
        return np.ones(1, dtype=np.float64)
    n = np.arange(length, dtype=np.float64)
    x = 2.0 * np.pi * n / (length - 1)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2.0 * x)


def analysis_window(size: int, window_length: int | None = None) -> np.ndarray:
    """Blackman analysis window of ``window_length`` zero-padded to ``size``."""
    if window_length is None:
        return blackman(size)
    win = blackman(window_length)
    return np.pad(win, (0, size - window_length))


@functools.lru_cache(maxsize=32)
def _biorthogonal_cached(size: int, shift: int, window_length: int | None) -> np.ndarray:
    win = analysis_window(size, window_length)
    if size % shift != 0:
        raise ValueError(f"fft size {size} must be a multiple of shift {shift}")
    n_shifts = size // shift

    # Periodic sum of squares of the analysis window with period `shift`.
    # One extra period is scanned (n_shifts + 1) but indices ≥ size - 1 are
    # excluded — including, deliberately, index size - 1 itself to match the
    # reference's off-by-one (its `analysis_index + 1 < fft_size` test).
    idx = np.arange(shift)[:, None] + shift * np.arange(n_shifts + 1)[None, :]
    valid = idx + 1 < size
    sq = np.where(valid, np.square(win[np.minimum(idx, size - 1)]), 0.0)
    sum_of_squares = np.tile(sq.sum(axis=1), n_shifts)

    # Krueger A.92 would divide by fft_size here; the reference multiplies the
    # result back by `size` before overlap-add, so the net window is simply:
    return win / sum_of_squares


def biorthogonal_synthesis_window(
    size: int, shift: int, window_length: int | None = None
) -> np.ndarray:
    """Net synthesis window used by the overlap-add iSTFT (float64)."""
    return _biorthogonal_cached(size, shift, window_length).copy()
