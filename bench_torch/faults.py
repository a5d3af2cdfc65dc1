"""Faults planted in the timed path, for the tests and readings that show
the comparison deciding ``correct`` catches them (never in a measured run):

- ``answer_altered``: every answer the system produces has its first
  speaker's estimate of its first row negated, where it is produced;
- ``half_batch``: the second half of every batch is left out, its rows
  replaced by the first half's, so a summed loss is twice the mean over the
  rows kept;
- ``state_unchanged``: a training step runs and then returns the model and
  the optimizer as they were before it.
"""

from __future__ import annotations

import torch

FAULTS = ("answer_altered", "half_batch", "state_unchanged")


def _check(fault: str | None, allowed: tuple[str, ...]) -> None:
    if fault is not None and fault not in allowed:
        raise ValueError(f"fault {fault!r} does not apply here (one of {', '.join(allowed)})")


def _halve(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[0] // 2
    out = x.clone()
    out[x.shape[0] - half:] = x[:half]
    return out


def _alter(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[0, 0] = -out[0, 0]
    return out


def separate(system, fault: str | None):
    """``system(mix, frame_lengths)`` with ``fault`` planted."""
    _check(fault, ("answer_altered", "half_batch"))
    if fault == "answer_altered":
        return lambda mix, frame_lengths: _alter(system(mix, frame_lengths))
    if fault == "half_batch":
        return lambda mix, frame_lengths: system(_halve(mix), _halve(frame_lengths))
    return system


def stream(apply_fn, fault: str | None):
    """A streaming window function with ``fault`` planted."""
    _check(fault, ("answer_altered",))
    if fault == "answer_altered":
        return lambda window: _alter(apply_fn(window))
    return apply_fn


class _Unchanged:
    def __init__(self, trainer):
        self.trainer = trainer

    def step(self, *batch):
        snap = self.trainer.snapshot()
        loss = self.trainer.step(*batch)
        self.trainer.restore(snap)
        return loss

    def __getattr__(self, name):
        return getattr(self.trainer, name)


class _Halved(_Unchanged):
    def step(self, *batch):
        return self.trainer.step(*(_halve(x) for x in batch))


def trainer(trainer, fault: str | None):
    """A trainer whose ``step`` has ``fault`` planted."""
    _check(fault, ("half_batch", "state_unchanged"))
    if fault == "state_unchanged":
        return _Unchanged(trainer)
    if fault == "half_batch":
        return _Halved(trainer)
    return trainer
