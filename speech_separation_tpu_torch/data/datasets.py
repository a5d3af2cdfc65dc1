"""Batching and host→device loading (counterpart of ``data/datasets.py``).

- :class:`WaveformLoader` — mix + sources as raw waveforms from a wsj0-2mix
  style split dir, padded to buckets (next multiple of a pad quantum), with
  true ``sample_lengths`` and STFT ``frame_lengths`` beside them;
- :func:`background_iterator` — decode ahead in a worker thread;
- :func:`prefetch_to_device` — keep batches in flight on the device: pinned
  host memory and ``.to(device, non_blocking=True)``.

Shuffling, length sorting and dynamic mixing serve training and wait for its
slice.
"""

from __future__ import annotations

import collections
import math
import pathlib
import queue as queue_mod
import threading
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..ops.stft import stft_frame_count
from .audio_io import audioread, quantize_i16
from .features import resolve_mix_dirname, utterance_names

__all__ = [
    "WaveformBatch",
    "WaveformLoader",
    "load_utterance_batch",
    "load_utterance_batch_i16",
    "background_iterator",
    "prefetch_to_device",
]


class WaveformBatch(NamedTuple):
    mix: np.ndarray  # [B, samples]
    sources: np.ndarray  # [B, num_speakers, samples]
    sample_lengths: np.ndarray  # [B] true waveform lengths
    frame_lengths: np.ndarray  # [B] true STFT frame counts
    names: tuple[str, ...]


def _round_up(value: int, quantum: int) -> int:
    return ((value + quantum - 1) // quantum) * quantum


def load_utterance_batch(split_dir, names, num_speakers: int, sample_rate: int):
    """Decode ``(mix, [s1..sN])`` float32 waveforms for every name."""
    split_dir = pathlib.Path(split_dir)
    mixdir = resolve_mix_dirname(split_dir)
    out = []
    for n in names:
        mix = audioread(split_dir / mixdir / n, sample_rate)
        srcs = [audioread(split_dir / f"s{i + 1}" / n, sample_rate) for i in range(num_speakers)]
        out.append((mix, srcs))
    return out


def load_utterance_batch_i16(split_dir, names, num_speakers: int, sample_rate: int):
    """int16 variant of :func:`load_utterance_batch`: the same values as int16
    counts (quantize∘decode is the identity on 16-bit PCM)."""
    return [
        (quantize_i16(mix), [quantize_i16(s) for s in srcs])
        for mix, srcs in load_utterance_batch(split_dir, names, num_speakers, sample_rate)
    ]


@dataclass
class WaveformLoader:
    """Batches of (mix, s1..sN) waveforms from a wsj0-2mix style split dir, in
    list order, each padded to the next multiple of ``pad_quantum_seconds``."""

    split_dir: str | pathlib.Path
    batch_size: int = 2
    sample_rate: int = 8000
    stft_size: int = 256
    stft_shift: int = 128
    num_speakers: int = 2
    pad_quantum_seconds: float = 1.0
    # int16 PCM counts instead of float32 (half the bytes to the device; the
    # separate step dequantizes bit-exactly for 16-bit sources)
    transfer_int16: bool = False
    names: list[str] = field(init=False)

    def __post_init__(self) -> None:
        self.split_dir = pathlib.Path(self.split_dir)
        self.names = utterance_names(self.split_dir)

    def __len__(self) -> int:
        return math.ceil(len(self.names) / self.batch_size)

    def __iter__(self) -> Iterator[WaveformBatch]:
        quantum = max(1, int(self.pad_quantum_seconds * self.sample_rate))
        load = load_utterance_batch_i16 if self.transfer_int16 else load_utterance_batch
        for start in range(0, len(self.names), self.batch_size):
            names = tuple(self.names[start : start + self.batch_size])
            loaded = load(self.split_dir, names, self.num_speakers, self.sample_rate)
            lengths = np.asarray([len(m) for m, _ in loaded], dtype=np.int32)
            padded = _round_up(int(lengths.max()), quantum)
            b = len(loaded)
            dtype = np.int16 if self.transfer_int16 else np.float32
            mix = np.zeros((b, padded), dtype=dtype)
            sources = np.zeros((b, self.num_speakers, padded), dtype=dtype)
            for i, (m, srcs) in enumerate(loaded):
                mix[i, : len(m)] = m
                for s, src in enumerate(srcs):
                    sources[i, s, : len(src)] = src
            frame_lengths = np.asarray(
                [stft_frame_count(int(x), self.stft_size, self.stft_shift) for x in lengths],
                dtype=np.int32,
            )
            yield WaveformBatch(mix, sources, lengths, frame_lengths, names)


def background_iterator(iterator, depth: int = 2):
    """Run ``iterator`` in a daemon worker thread, buffering up to ``depth``
    items. Order is preserved; worker exceptions re-raise at the consumer."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=max(1, depth))
    sentinel = object()
    error: list[BaseException] = []

    def _worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as exc:  # re-raised on the consumer side
            error.append(exc)
        finally:
            q.put(sentinel)

    threading.Thread(target=_worker, daemon=True, name="decode-prefetch").start()
    while True:
        item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item


def _to_device(batch, device: torch.device):
    def put(x):
        if not isinstance(x, np.ndarray):
            return x
        tensor = torch.from_numpy(x)
        if device.type == "cuda":
            tensor = tensor.pin_memory()
        return tensor.to(device, non_blocking=True)

    return type(batch)(*(put(x) for x in batch))


def prefetch_to_device(iterator, device, depth: int = 2):
    """Overlapped host→device feeding: decode ahead in a worker thread and
    keep ``depth`` transferred batches in flight (double buffering).

    Every numpy field of each batch becomes a tensor on ``device``; other
    fields (names) pass through."""
    device = torch.device(device)
    pending = collections.deque()
    for batch in background_iterator(iterator, depth=depth):
        pending.append(_to_device(batch, device))
        if len(pending) >= depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()
