"""Host-side audio I/O (a numpy copy of ``data/audio_io.py``, without JAX).

- :func:`read_wav` — PCM/float wav → float32 in [-1, 1] (librosa.load scaling);
- :func:`audioread` — read + FFT resample to a target rate;
- :func:`read_normalized` — FFT resample then peak-normalise;
- :func:`quantize_i16` — float in [-1, 1] → int16 counts (inverse of i/32768);
- :func:`audiowrite` — float → int16 with clip accounting, optional peak
  normalisation, optional threaded write.

The JAX package's optional native decoder is not used: the numpy decode gives
the same values.
"""

from __future__ import annotations

import pathlib
import threading
import wave

import numpy as np
from scipy.io import wavfile as _wavfile
from scipy.signal import resample as _fft_resample

__all__ = [
    "read_wav",
    "audioread",
    "read_normalized",
    "quantize_i16",
    "audiowrite",
    "wait_for_pending_writes",
    "wav_duration_samples",
]


def read_wav(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """Read a wav file as float32 in [-1, 1]. Returns (signal, sample_rate)."""
    rate, data = _wavfile.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, int(rate)


def audioread(path: str | pathlib.Path, sample_rate: int = 8000) -> np.ndarray:
    """Read and resample to ``sample_rate`` (float32, mono, [-1, 1])."""
    data, rate = read_wav(path)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if rate != sample_rate:
        n = round(len(data) * float(sample_rate) / rate)
        data = _fft_resample(data, n).astype(np.float32)
    return data


def read_normalized(path: str | pathlib.Path, sample_rate: int = 8000) -> np.ndarray:
    """Raw integer samples, FFT resample, divide by the peak magnitude."""
    rate, data = _wavfile.read(str(path))
    data = np.asarray(data, dtype=np.float64)
    if data.ndim > 1:
        data = data.mean(axis=1)
    n = round(len(data) * float(sample_rate) / rate)
    data = _fft_resample(data, n)
    peak = np.max(np.abs(data))
    if peak > 0:
        data = data / peak
    return data.astype(np.float32)


def quantize_i16(data: np.ndarray) -> np.ndarray:
    """Quantize float waveforms in [-1, 1] to int16 PCM counts.

    For audio decoded from 16-bit PCM at the target rate, ``round(x * 32768)``
    recovers the original integer exactly; +1.0 and above clip to 32767.
    """
    return np.clip(np.round(data * 32768.0), -32768, 32767).astype(np.int16)


_pending_writes: list[threading.Thread] = []
_pending_lock = threading.Lock()


def audiowrite(
    data: np.ndarray,
    path: str | pathlib.Path,
    samplerate: int = 8000,
    normalize: bool = False,
    threaded: bool = False,
) -> int:
    """Write float audio as int16 wav; returns the number of clipped samples."""
    data = np.asarray(data, dtype=np.float64).copy()
    int16_max = np.iinfo(np.int16).max
    int16_min = np.iinfo(np.int16).min
    if normalize:
        peak = np.max(np.abs(data))
        if peak > 0:
            data /= peak
    data *= int16_max
    clipped = int(np.sum(data > int16_max) + np.sum(data < int16_min))
    pcm = np.clip(data, int16_min, int16_max).astype(np.int16)

    def _write() -> None:
        _wavfile.write(str(path), samplerate, pcm)

    if threaded:
        thread = threading.Thread(target=_write, daemon=True)
        with _pending_lock:
            _pending_writes.append(thread)
        thread.start()
    else:
        _write()
    return clipped


def wait_for_pending_writes() -> None:
    """Join every outstanding threaded write."""
    while True:
        with _pending_lock:
            if not _pending_writes:
                return
            thread = _pending_writes.pop()
        thread.join()


def wav_duration_samples(path: str | pathlib.Path) -> tuple[int, int]:
    """(num_frames, sample_rate) without decoding the payload."""
    with wave.open(str(path)) as handle:
        return handle.getnframes(), handle.getframerate()
