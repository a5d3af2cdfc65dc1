"""Sequence packing: fixed-shape rows of whole utterances for recurrent
training (counterpart of ``data/packing.py``).

Several utterances are packed end to end into rows of ``row_frames`` STFT
frames, so every batch has one shape and the only dead frames are the row
tails the first-fit planner could not fill. Training semantics are exact:
the BiLSTM's carry gate (``models.blstm.segment_keep``) isolates each
utterance in both scan directions, and ``losses.pit.pit_loss_packed`` runs the
permutation search and length normalisation per utterance.

Geometry: with the STFT's fade padding (``size - shift`` zeros on both ends),
utterance ``u`` of ``L_u`` samples owns ``K_u = stft_frame_count(L_u)``
frames and starts at row sample ``q_u * shift``, ``q_u`` its first frame
slot. Because ``K_u * shift >= L_u + (size - shift)``, no analysis window of
``u`` reaches another utterance's samples even back to back: packing needs
no guard frames, and every frame of ``u`` in the row equals the same frame of
``u`` alone. A row of ``row_frames`` frames is ``row_frames * shift - (size
- shift)`` samples.
"""

from __future__ import annotations

import math
import pathlib
from dataclasses import dataclass, field
from typing import Iterator, NamedTuple

import numpy as np

from ..ops.stft import stft_frame_count
from .audio_io import wav_duration_samples
from .datasets import load_utterance_batch, load_utterance_batch_i16
from .features import resolve_mix_dirname, utterance_names

__all__ = ["PackedBatch", "PackedWaveformLoader", "plan_rows"]


class PackedBatch(NamedTuple):
    mix: np.ndarray  # [R, row_samples]
    sources: np.ndarray  # [R, num_speakers, row_samples]
    frame_seg: np.ndarray  # [R, row_frames] int32 segment ids, -1 = guard/tail
    names: tuple[tuple[str, ...], ...]  # per-row utterance names
    audio_seconds: float  # total true (unpadded) audio in this batch


def plan_rows(
    frames: list[int], row_frames: int, guard: int, order: np.ndarray
) -> list[list[int]]:
    """First-fit packing of utterances (by frame count) into rows.

    Visits items in ``order`` (shuffled per epoch for stochasticity) and
    places each into the first open row with space; rows are closed once
    full. Returns a list of rows, each a list of item indices in placement
    order. O(N · open_rows) with a small open-row window.
    """
    rows: list[list[int]] = []
    free: list[int] = []  # next free frame slot per open row
    open_idx: list[int] = []  # indices into rows that are still open
    for i in order:
        k = frames[i]
        if k > row_frames:
            raise ValueError(
                f"utterance of {k} frames exceeds row capacity {row_frames}"
            )
        placed = False
        for j, r in enumerate(open_idx):
            if free[r] + k <= row_frames:
                rows[r].append(i)
                free[r] += k + guard
                if free[r] >= row_frames:
                    open_idx.pop(j)
                placed = True
                break
        if not placed:
            rows.append([i])
            free.append(k + guard)
            open_idx.append(len(rows) - 1)
            # bound the scan window: keep at most 64 open rows
            if len(open_idx) > 64:
                open_idx.pop(0)
    return rows


@dataclass
class PackedWaveformLoader:
    """Packs a wsj0-2mix style split into fixed-shape rows of utterances.

    Yields :class:`PackedBatch` of ``rows_per_batch`` rows, each
    ``row_frames`` STFT frames long. Lengths come from wav headers (no
    decode; under resampling, the decoded length); decoding happens per
    batch. ``shuffle`` re-plans each epoch under ``default_rng(seed +
    epoch)``'s permutation, the JAX loader's order.
    """

    split_dir: str | pathlib.Path
    rows_per_batch: int = 16
    row_seconds: float = 16.0
    row_frames: int | None = None  # overrides row_seconds
    sample_rate: int = 8000
    stft_size: int = 256
    stft_shift: int = 128
    num_speakers: int = 2
    shuffle: bool = False
    seed: int = 0
    drop_remainder: bool = False
    # int16 PCM counts to the device (half the fp32 bytes; the steps
    # dequantize bit-exactly for 16-bit sources)
    transfer_int16: bool = False
    names: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.split_dir = pathlib.Path(self.split_dir)
        if not self.names:
            self.names = utterance_names(self.split_dir)
        if self.row_frames is None:
            self.row_frames = stft_frame_count(
                int(self.row_seconds * self.sample_rate),
                self.stft_size,
                self.stft_shift,
            )
        # row_samples such that stft(row) (fading=True) yields exactly
        # row_frames frames: T·shift − (size − shift)
        self.row_samples = self.row_frames * self.stft_shift - (
            self.stft_size - self.stft_shift
        )
        # fading=True gives every utterance (size − shift) zeros of its own
        # on both ends — segments pack back-to-back with no guard frames
        self.guard = 0
        if not self.names:
            raise ValueError(f"no utterances found under {self.split_dir}")
        self._lengths = []
        mixdir = resolve_mix_dirname(self.split_dir)
        for n in self.names:
            frames, rate = wav_duration_samples(self.split_dir / mixdir / n)
            if rate != self.sample_rate:
                # decode resamples (audio_io.audioread): plan with the
                # decoded length, not the header length, or row placement
                # would silently overlap neighbouring utterances
                frames = round(frames * float(self.sample_rate) / rate)
            self._lengths.append(frames)
        self._frames = [
            stft_frame_count(l, self.stft_size, self.stft_shift)
            for l in self._lengths
        ]
        # per-loader bound on segments a row (the packed loss's segment count)
        self.num_segments = self.row_frames // (min(self._frames) + self.guard) + 1
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (resume): the next epoch's order comes from
        ``default_rng(seed + epoch)``, continuing the stream, not replaying it."""
        self._epoch = int(epoch)

    def frame_occupancy(self) -> float:
        """Fraction of row frames carrying real utterance content (planning
        with the deterministic epoch-0 order)."""
        rows = plan_rows(
            self._frames, self.row_frames, self.guard, np.arange(len(self.names))
        )
        used = sum(self._frames[i] for r in rows for i in r)
        return used / (len(rows) * self.row_frames)

    def __len__(self) -> int:
        # NOTE: planned with the deterministic epoch-0 order; shuffled epochs
        # re-plan under their permutation and can differ by ±1 batch — treat
        # len() as an estimate for progress display, not a step budget.
        rows = plan_rows(
            self._frames, self.row_frames, self.guard, np.arange(len(self.names))
        )
        n = len(rows)
        if self.drop_remainder:
            return n // self.rows_per_batch
        return math.ceil(n / self.rows_per_batch)

    def __iter__(self) -> Iterator[PackedBatch]:
        order = np.arange(len(self.names))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._epoch += 1
            order = rng.permutation(order)
        rows = plan_rows(self._frames, self.row_frames, self.guard, order)
        shift = self.stft_shift
        for start in range(0, len(rows), self.rows_per_batch):
            chunk = rows[start : start + self.rows_per_batch]
            if self.drop_remainder and len(chunk) < self.rows_per_batch:
                return
            flat_names = [self.names[i] for row in chunk for i in row]
            load = load_utterance_batch_i16 if self.transfer_int16 else load_utterance_batch
            decoded = load(self.split_dir, flat_names, self.num_speakers, self.sample_rate)
            r = len(chunk)
            dtype = np.int16 if self.transfer_int16 else np.float32
            mix = np.zeros((r, self.row_samples), dtype=dtype)
            sources = np.zeros(
                (r, self.num_speakers, self.row_samples), dtype=dtype
            )
            frame_seg = np.full((r, self.row_frames), -1, dtype=np.int32)
            audio = 0
            pos = 0
            for ri, row in enumerate(chunk):
                q = 0
                for si, i in enumerate(row):
                    m, srcs = decoded[pos]
                    pos += 1
                    k = self._frames[i]
                    s0 = q * shift
                    mix[ri, s0 : s0 + len(m)] = m
                    for s, src in enumerate(srcs):
                        sources[ri, s, s0 : s0 + len(src)] = src
                    frame_seg[ri, q : q + k] = si
                    audio += len(m)
                    q += k + self.guard
            yield PackedBatch(
                mix,
                sources,
                frame_seg,
                tuple(tuple(self.names[i] for i in row) for row in chunk),
                audio / self.sample_rate,
            )
