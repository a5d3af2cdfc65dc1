"""Device-resident packed corpus (counterpart of ``data/device_dataset.py``):
pack a split once, hold its rows on the device, and feed each step only row
indices.

Rows are packed once with the deterministic plan; shuffled epochs reorder
whole rows (the utterance-to-row assignment is fixed). Per-utterance loss
semantics are unchanged. Use with ``train.make_upit_packed_resident_steps``,
which gathers the rows on the device and runs the packed loss.
"""

from __future__ import annotations

import math
import pathlib
from typing import Iterator

import numpy as np
import torch

from .packing import PackedWaveformLoader

__all__ = ["ResidentPackedCorpus"]


class ResidentPackedCorpus:
    """Packs a split into rows once and places the arrays on ``device``
    (default the GPU).

    ``mix [R, row_samples]``, ``sources [R, S, row_samples]`` (int16 when
    ``transfer_int16``, the default: half the upload and memory) and
    ``frame_seg [R, row_frames]`` int32 are tensors on the device. Iterating
    yields int32 row-index tensors on the device, ``rows_per_batch`` each:
    with ``shuffle=True`` the order is drawn each epoch from
    ``default_rng(seed + epoch)`` and the ragged tail dropped; otherwise the
    rows are padded up to a whole batch with empty rows (every frame ``-1``),
    which add exactly 0 to the packed loss.
    """

    def __init__(
        self,
        split_dir,
        rows_per_batch: int = 16,
        shuffle: bool = False,
        seed: int = 0,
        transfer_int16: bool = True,
        device: torch.device | str = "cuda",
        **packed_kwargs,
    ) -> None:
        self.split_dir = pathlib.Path(split_dir)
        self.rows_per_batch = rows_per_batch
        self.shuffle = shuffle
        self.seed = seed
        self.device = torch.device(device)
        loader = PackedWaveformLoader(
            self.split_dir,
            rows_per_batch=1 << 30,  # every row in one host batch
            transfer_int16=transfer_int16,
            **packed_kwargs,
        )
        self.num_segments = loader.num_segments
        batch = next(iter(loader))
        mix, sources, frame_seg = batch.mix, batch.sources, batch.frame_seg
        self.names = batch.names
        self.audio_seconds = batch.audio_seconds
        self.num_rows = mix.shape[0]
        if not shuffle:
            pad = (-self.num_rows) % rows_per_batch
            mix = np.concatenate([mix, np.zeros((pad, *mix.shape[1:]), mix.dtype)])
            sources = np.concatenate([sources, np.zeros((pad, *sources.shape[1:]), sources.dtype)])
            frame_seg = np.concatenate([frame_seg,
                                        np.full((pad, frame_seg.shape[1]), -1, np.int32)])
        self.padded_rows = mix.shape[0]
        self.mix, self.sources, self.frame_seg = (
            torch.from_numpy(a).to(self.device) for a in (mix, sources, frame_seg)
        )
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (resume): the next order comes from
        ``default_rng(seed + epoch)``."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        if self.shuffle:
            return self.num_rows // self.rows_per_batch
        return math.ceil(self.num_rows / self.rows_per_batch)

    def __iter__(self) -> Iterator[torch.Tensor]:
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            self._epoch += 1
            order = rng.permutation(self.num_rows)[: len(self) * self.rows_per_batch]
        else:
            order = np.arange(self.padded_rows)
        order = torch.from_numpy(order.astype(np.int32)).to(self.device)
        for start in range(0, len(order), self.rows_per_batch):
            yield order[start : start + self.rows_per_batch]
