"""Batching and host→device loading (counterpart of ``data/datasets.py``).

- :class:`WaveformLoader` — mix + sources as raw waveforms from a wsj0-2mix
  style split dir, padded to buckets (next multiple of a pad quantum), with
  true ``sample_lengths`` and STFT ``frame_lengths`` beside them;
- :class:`VaeLoader` — single-source batches for the VQ-VAE codecs,
  sample-level ``[B, T, 1]`` or frame-stacked ``[B, K, L]``;
- :func:`background_iterator` — decode ahead in a worker thread;
- :func:`prefetch_to_device` — keep batches in flight on the device: pinned
  host memory and ``.to(device, non_blocking=True)``;
- :func:`to_host` — results back to the host in page-locked memory.

Training adds per-epoch shuffling (``default_rng(seed + epoch)``, the JAX
loader's order, so one seed gives the same batches in both packages),
``set_epoch`` for resume, ``drop_remainder``, ``sort_by_length`` and dynamic
mixing (``dynamic_mix``: every epoch re-pairs source slots across utterances,
draws fresh zero-mean gains and random crops, and remixes on the host, from
the same ``default_rng((seed, 7919, epoch))`` draws as the JAX loader, so the
batches are bit-identical).
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
from ..utils.profiling import span
from .audio_io import audioread, quantize_i16, read_normalized, wav_duration_samples
from .features import resolve_mix_dirname, utterance_names

__all__ = [
    "WaveformBatch",
    "WaveformLoader",
    "VaeBatch",
    "VaeLoader",
    "load_utterance_batch",
    "load_utterance_batch_i16",
    "load_source_files",
    "background_iterator",
    "prefetch_to_device",
    "to_host",
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


def load_source_files(split_dir, names, slot: int, sample_rate: int):
    """Decode one source slot (``s{slot+1}/name`` for every name) to float32:
    the dynamic-mixing path re-pairs slots across utterances, so it loads rows
    a slot at a time."""
    split_dir = pathlib.Path(split_dir)
    return [audioread(split_dir / f"s{slot + 1}" / n, sample_rate) for n in names]


@dataclass
class WaveformLoader:
    """Batches of (mix, s1..sN) waveforms from a wsj0-2mix style split dir,
    each padded to the next multiple of the pad quantum.

    ``shuffle`` draws each epoch's order from ``default_rng(seed + epoch)``;
    ``sort_by_length`` orders utterances by duration (wav headers only) and
    then shuffles whole batches, keeping similar lengths together.

    ``dynamic_mix`` (the standard wsj0-2mix augmentation): every epoch slot 0
    keeps its utterance while slots 1..S-1 draw their source from a
    permutation within windows of ``dynamic_window_batches`` adjacent batches
    (length-homogeneous under ``sort_by_length``); each row's sources are
    random-cropped to the row's shortest, gained by fresh zero-mean offsets
    within ±``dynamic_gain_db`` and summed into the mix on the host. Targets
    are the gained sources, so ``mix == Σ sources`` holds exactly (on the
    int16 path as an unclipped int32 mix lane)."""

    split_dir: str | pathlib.Path
    batch_size: int = 2
    sample_rate: int = 8000
    stft_size: int = 256
    stft_shift: int = 128
    num_speakers: int = 2
    pad_quantum_seconds: float = 1.0
    pad_quantum_samples: int | None = None  # overrides pad_quantum_seconds
    shuffle: bool = False
    seed: int = 0
    drop_remainder: bool = False
    sort_by_length: bool = False
    # int16 PCM counts instead of float32 (half the bytes to the device; the
    # steps dequantize bit-exactly for 16-bit sources)
    transfer_int16: bool = False
    dynamic_mix: bool = False
    dynamic_gain_db: float = 2.5
    # re-pair only within windows of this many adjacent batches of the
    # (length-sorted) order, bounding what the crops to the shortest discard
    dynamic_window_batches: int = 4
    names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.split_dir = pathlib.Path(self.split_dir)
        if not self.names:
            self.names = utterance_names(self.split_dir)
        if self.sort_by_length:
            mixdir = resolve_mix_dirname(self.split_dir)
            durations = [
                wav_duration_samples(self.split_dir / mixdir / n)[0] for n in self.names
            ]
            self.names = [n for _, n in sorted(zip(durations, self.names))]
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (resume): the next epoch's order comes from
        ``default_rng(seed + epoch)``, continuing the stream, not replaying it."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.names)
        return n // self.batch_size if self.drop_remainder else math.ceil(n / self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.names)
        pos = np.arange(n)
        if not self.shuffle:
            if self.dynamic_mix:
                self._epoch += 1  # fresh pairings and gains without shuffling too
            return pos
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        if self.sort_by_length:
            groups = [pos[s : s + self.batch_size] for s in range(0, n, self.batch_size)]
            rng.shuffle(groups)
            return np.concatenate(groups) if groups else pos
        return rng.permutation(pos)

    def _pairings(self, epoch: int) -> tuple[np.ndarray, np.random.Generator]:
        """``(slot_idx [S, n], rng)``: each slot's utterance per position of
        the unshuffled order, slots 1..S-1 permuted within windows, and the
        epoch's generator, whose later draws are the gains and crops."""
        n = len(self.names)
        rng = np.random.default_rng((self.seed, 7919, epoch))
        w = max(1, self.dynamic_window_batches * self.batch_size)
        slot_idx = np.tile(np.arange(n), (self.num_speakers, 1))
        for s in range(1, self.num_speakers):
            for ws in range(0, n, w):
                rng.shuffle(slot_idx[s, ws : ws + w])
        return slot_idx, rng

    def __iter__(self) -> Iterator[WaveformBatch]:
        if self.dynamic_mix:
            slot_idx, dm_rng = self._pairings(self._epoch)
        order = self._order()
        if self.dynamic_mix:
            slot_idx = slot_idx[:, order]
        quantum = self.pad_quantum_samples or max(
            1, int(self.pad_quantum_seconds * self.sample_rate)
        )
        load = load_utterance_batch_i16 if self.transfer_int16 else load_utterance_batch
        for start in range(0, len(order), self.batch_size):
            idx = order[start : start + self.batch_size]
            if self.drop_remainder and len(idx) < self.batch_size:
                return
            names = tuple(self.names[i] for i in idx)
            if self.dynamic_mix:
                yield self._dynamic_batch(slot_idx[:, start : start + len(idx)], names, quantum,
                                          dm_rng)
                continue
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

    def _dynamic_batch(self, batch_slots, names, quantum, dm_rng) -> WaveformBatch:
        """One dynamically mixed batch: each slot's (re-paired) sources
        decoded, random-cropped to the row's shortest, gained, remixed."""
        n_src, b = batch_slots.shape
        decoded = [
            load_source_files(self.split_dir, [self.names[i] for i in batch_slots[s]], s,
                              self.sample_rate)
            for s in range(n_src)
        ]
        lengths = np.asarray([min(len(decoded[s][i]) for s in range(n_src)) for i in range(b)],
                             dtype=np.int32)
        padded = _round_up(int(lengths.max()), quantum)
        gains_db = dm_rng.uniform(-self.dynamic_gain_db, self.dynamic_gain_db, (b, n_src))
        gains_db -= gains_db.mean(axis=1, keepdims=True)
        gains = 10.0 ** (gains_db / 20.0)
        sources = np.zeros((b, n_src, padded),
                           dtype=np.int16 if self.transfer_int16 else np.float32)
        for i in range(b):
            ln = int(lengths[i])
            cuts = []
            for s in range(n_src):
                src = decoded[s][i]
                off = int(dm_rng.integers(0, len(src) - ln + 1))
                cuts.append(src[off : off + ln] * gains[i, s])
            # a gain can push a near-full-scale source past ±1, where the int16
            # path would clip and part from the float path: attenuate the whole
            # row (every source alike, so mix == Σ sources and the relative
            # gains hold), on both paths, to 32767/32768 and not 1.0, which
            # quantizes to 32768 and clips by one count
            peak = max(float(np.abs(c).max(initial=0.0)) for c in cuts)
            if peak > 1.0:
                cuts = [c * (32767.0 / 32768.0 / peak) for c in cuts]
            for s in range(n_src):
                sources[i, s, :ln] = quantize_i16(cuts[s]) if self.transfer_int16 else cuts[s]
        if self.transfer_int16:
            # the mix ships as the unclipped int32 sum of the quantized sources
            # (two gained near-full-scale sources can pass ±32767); dequant_i16
            # scales the int32 lane by the same 1/32768
            mix = sources.astype(np.int32).sum(axis=1, dtype=np.int32)
        else:
            mix = sources.sum(axis=1)
        frame_lengths = np.asarray(
            [stft_frame_count(int(x), self.stft_size, self.stft_shift) for x in lengths],
            dtype=np.int32,
        )
        return WaveformBatch(mix, sources, lengths, frame_lengths, names)


class VaeBatch(NamedTuple):
    inputs: np.ndarray  # [B, T, 1] or [B, K, L]
    targets: np.ndarray  # [B, T, 1] waveform targets
    lengths: np.ndarray  # [B] true waveform lengths
    names: tuple[str, ...]


@dataclass
class VaeLoader:
    """Single-source batches for the VQ-VAE codec family, peak-normalised
    (``read_normalized``).

    ``stacked=False``: sample-level ``[B, T, 1]``, the batch padded up to whole
    seconds. ``stacked=True``: frame-stacked ``[B, K, L]``, each utterance's K
    rounded up to a multiple of ``stride_alignment`` so the strided encoders
    and decoders invert cleanly, and the batch's K up to a quantum of
    ``pad_quantum_seconds`` (itself a multiple of the alignment). ``shuffle``
    draws each epoch's order from ``default_rng(seed + epoch)``, the JAX
    loader's order."""

    split_dir: str | pathlib.Path
    source: str = "s1"
    batch_size: int = 2
    sample_rate: int = 8000
    stacked: bool = False
    frame_size: int = 40
    stride_alignment: int = 4
    pad_quantum_seconds: float = 1.0
    shuffle: bool = False
    seed: int = 0
    names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.split_dir = pathlib.Path(self.split_dir)
        if not self.names:
            self.names = utterance_names(self.split_dir)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (resume): the next order comes from
        ``default_rng(seed + epoch)``."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return math.ceil(len(self.names) / self.batch_size)

    def __iter__(self) -> Iterator[VaeBatch]:
        order = np.arange(len(self.names))
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(order)
            self._epoch += 1
        for start in range(0, len(order), self.batch_size):
            names = tuple(self.names[i] for i in order[start : start + self.batch_size])
            wavs = [read_normalized(self.split_dir / self.source / n, self.sample_rate)
                    for n in names]
            lengths = np.asarray([len(w) for w in wavs], dtype=np.int32)
            if not self.stacked:
                batch = np.zeros((len(wavs), _round_up(int(lengths.max()), self.sample_rate), 1),
                                 dtype=np.float32)
                for i, w in enumerate(wavs):
                    batch[i, : len(w), 0] = w
                yield VaeBatch(batch, batch, lengths, names)
                continue
            frame = self.frame_size
            ks = [_round_up(math.ceil(len(w) / frame), self.stride_alignment) for w in wavs]
            quantum = _round_up(max(1, int(self.pad_quantum_seconds * self.sample_rate / frame)),
                                self.stride_alignment)
            k_max = _round_up(max(ks), quantum)
            inputs = np.zeros((len(wavs), k_max, frame), dtype=np.float32)
            targets = np.zeros((len(wavs), k_max * frame, 1), dtype=np.float32)
            for i, (w, k) in enumerate(zip(wavs, ks)):
                padded = np.zeros(k * frame, dtype=np.float32)
                padded[: len(w)] = w
                inputs[i, :k] = padded.reshape(k, frame)
                targets[i, : k * frame, 0] = padded
            yield VaeBatch(inputs, targets, lengths, names)


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

    with span("feed.pin"):  # the batch's fields pinned and their copies queued
        return type(batch)(*(put(x) for x in batch))


def to_host(x):
    """``x``, a tensor or a tuple of them, on the host, ready to read.

    A CUDA tensor is copied once into a new page-locked tensor, which the
    copy engine fills at the link's full rate (a pageable ``.cpu()`` goes
    through a CUDA staging buffer and faults in fresh pages), and the
    call waits for the copy. The memory comes from torch's caching host
    allocator, which hands a block out again only once the tensor and every
    view of it are gone, so a result stays valid for as long as anything
    holds it. A CPU tensor is returned as it is."""
    if isinstance(x, tuple):
        return tuple(to_host(t) for t in x)
    if x.device.type != "cuda":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x, non_blocking=True)
    torch.cuda.current_stream(x.device).synchronize()
    return host


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
