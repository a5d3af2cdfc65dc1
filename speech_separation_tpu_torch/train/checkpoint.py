"""Best-validation checkpoints with full-state resume (counterpart of
``train/checkpoint.py``, orbax there).

Each snapshot is one ``torch.save`` file, ``ckpt_{step}.pt``, holding the
whole :class:`~.state.TrainState` (model, optimizer moments and count, step,
dropout generator) and its validation loss; ``checkpoints.json`` indexes
them. The manager keeps the ``max_to_keep`` snapshots with the lowest
validation loss, as orbax's ``best_fn`` retention does.
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Any

import torch

__all__ = ["CheckpointManager"]

_INDEX = "checkpoints.json"


def _write_atomic(path: pathlib.Path, write) -> None:
    """``write(tmp)`` then rename: a reader never sees a partial file."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 3):
        self._dir = pathlib.Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        index = self._dir / _INDEX
        self._losses: dict[int, float] = (
            {int(k): float(v) for k, v in json.loads(index.read_text()).items()}
            if index.exists()
            else {}
        )

    def _path(self, step: int) -> pathlib.Path:
        return self._dir / f"ckpt_{step}.pt"

    def save_if_best(self, step: int, state: Any, val_loss: float) -> bool:
        """Save a snapshot; keep the best ``max_to_keep`` by validation loss.
        Returns whether the snapshot is among those kept."""
        payload = {"step": int(step), "val_loss": float(val_loss), "state": state.state_dict()}
        _write_atomic(self._path(step), lambda p: torch.save(payload, p))
        self._losses[int(step)] = float(val_loss)
        ranked = sorted(self._losses, key=lambda s: (self._losses[s], -s))
        for dropped in ranked[self._max_to_keep :]:
            del self._losses[dropped]
            self._path(dropped).unlink(missing_ok=True)
        _write_atomic(
            self._dir / _INDEX,
            lambda p: p.write_text(json.dumps({str(k): v for k, v in sorted(self._losses.items())})),
        )
        return int(step) in self._losses

    @property
    def best_step(self) -> int | None:
        if not self._losses:
            return None
        return min(self._losses, key=lambda s: (self._losses[s], -s))

    @property
    def latest_step(self) -> int | None:
        return max(self._losses) if self._losses else None

    def _load(self, step: int | None) -> dict[str, Any]:
        if step is None:
            step = self.best_step
        if step is None or not self._path(step).exists():
            raise FileNotFoundError(f"no checkpoint {'' if step is None else step} under {self._dir}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, state: Any, step: int | None = None) -> Any:
        """Load the whole snapshot ``step`` (default: the best) into ``state``."""
        state.load_state_dict(self._load(step)["state"])
        return state

    def restore_params(self, state: Any, step: int | None = None) -> Any:
        """Load only the model parameters (serving; immune to optimizer drift)."""
        state.model.load_state_dict(self._load(step)["state"]["model"])
        return state

    def close(self) -> None:
        """Nothing to flush: every save is written before it returns."""
