"""Epoch driver with validation, early stopping and divergence abort
(counterpart of ``train/loop.py``).

- per-epoch train pass → validation pass → checkpoint when validation improves;
- early stop after ``patience`` epochs without improvement; at the end the
  state holds the best snapshot (the full train state, not only the weights);
- a non-finite train loss aborts the run mid-epoch, checked every
  ``nan_check_every`` steps, and restores the best finite state
  (``FitResult.diverged``);
- ``resume=True`` restarts from the newest checkpoint and continues the
  loader's shuffle stream (``set_epoch``);
- batches are decoded in a worker thread and copied to the device ahead of
  use; step losses stay on the device and are fetched in one transfer at
  epoch end, so logging adds no per-step host sync.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import numpy as np
import torch

from ..data.datasets import prefetch_to_device
from .checkpoint import CheckpointManager

__all__ = ["FitResult", "fit"]


@dataclass
class FitResult:
    state: Any
    history: dict[str, list[float]] = field(default_factory=dict)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    stopped_early: bool = False
    diverged: bool = False


def fit(
    state: Any,
    train_step: Callable,
    eval_step: Callable,
    train_loader: Iterable,
    val_loader: Iterable,
    batch_arrays: Callable,
    epochs: int = 5,
    patience: int = 50,
    checkpoints: CheckpointManager | None = None,
    log_fn: Callable[[str], None] = print,
    resume: bool = False,
    metrics: Any = None,
    nan_check_every: int = 25,
) -> FitResult:
    """Train with per-epoch validation.

    ``batch_arrays(batch)`` picks the positional tensors a step takes from a
    loader batch (already on the device). ``train_step(state, *arrays) ->
    (state, loss)``; ``eval_step(state, *arrays) -> loss``. ``metrics`` is an
    optional ``MetricsLogger``; ``nan_check_every`` bounds how many steps a
    divergent run can waste (0 → only at epoch end).
    """
    device = next(state.model.parameters()).device
    epoch_offset = 0
    if resume and checkpoints is not None and checkpoints.latest_step is not None:
        latest = checkpoints.latest_step
        # continue the shuffle stream: checkpoint steps count epochs
        epoch_offset = int(latest)
        try:
            state = checkpoints.restore(state, step=latest)
            log_fn(f"resumed from checkpoint step {latest}")
        except (KeyError, ValueError):
            # optimizer-state drift: restore the parameters only, restart the
            # moments, and fast-forward the step and the schedule's count
            state = checkpoints.restore_params(state, step=latest)
            steps = epoch_offset * len(train_loader) if hasattr(train_loader, "__len__") else 0
            state.step = steps
            for group in state.optimizer.param_groups:
                group["count"] = steps
            log_fn(
                f"resumed PARAMS ONLY from checkpoint step {latest} (optimizer-state "
                f"drift; moments restart, LR schedule fast-forwarded to step {steps})"
            )

    result = FitResult(state=state, history={"loss": [], "val_loss": []})
    best = state.snapshot()
    since_best = 0
    global_step = state.step

    for epoch in range(1, epochs + 1):
        if epoch_offset and hasattr(train_loader, "set_epoch"):
            train_loader.set_epoch(epoch_offset + epoch - 1)
        t0 = time.time()
        train_losses = []
        diverged_at = None
        for batch in prefetch_to_device(iter(train_loader), device):
            state, loss, *_ = _as_tuple(train_step(state, *batch_arrays(batch)))
            train_losses.append(loss)
            global_step += 1
            if nan_check_every and len(train_losses) % nan_check_every == 0:
                if not np.isfinite(float(train_losses[-1])):
                    diverged_at = global_step
                    break
        if diverged_at is None and train_losses and not np.isfinite(float(train_losses[-1])):
            diverged_at = global_step
        if diverged_at is not None:
            result.diverged = True
            log_fn(
                f"non-finite train loss at step {diverged_at} (epoch {epoch}); "
                f"stopping and restoring best state (epoch {result.best_epoch})"
            )
            break
        if not train_losses:
            raise ValueError(
                f"train loader yielded no batches in epoch {epoch}; "
                f"check the split directory / utterance lists"
            )
        val_losses = []
        for batch in prefetch_to_device(iter(val_loader), device):
            out = eval_step(state, *batch_arrays(batch))
            val_losses.append(out[0] if isinstance(out, tuple) else out)

        step_losses = _fetch_scalars(train_losses)
        train_loss = float(np.mean(step_losses))
        vals = _fetch_scalars(val_losses)
        val_loss = float(np.mean(vals)) if vals else float("nan")
        result.history["loss"].append(train_loss)
        result.history["val_loss"].append(val_loss)
        epoch_time = time.time() - t0
        if metrics is not None:
            first_step = global_step - len(step_losses) + 1
            for i, step_loss in enumerate(step_losses):
                metrics.log(first_step + i, loss=step_loss)
            metrics.log(
                global_step,
                epoch=epoch,
                train_loss=train_loss,
                val_loss=val_loss,
                epoch_time_s=round(epoch_time, 3),
            )
        log_fn(
            f"epoch {epoch}/{epochs}  loss={train_loss:.5f}  val_loss={val_loss:.5f}"
            f"  ({epoch_time:.2f}s)"
        )

        if val_loss < result.best_val_loss:
            result.best_val_loss = val_loss
            result.best_epoch = epoch
            best = state.snapshot()
            since_best = 0
            if checkpoints is not None:
                # cumulative step: a resumed chunk never reuses an earlier step
                checkpoints.save_if_best(epoch_offset + epoch, state, val_loss)
        else:
            since_best += 1
            if since_best > patience:
                result.stopped_early = True
                log_fn(f"early stopping at epoch {epoch} (best epoch {result.best_epoch})")
                break

    state.load_state_dict(best)
    result.state = state
    return result


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _fetch_scalars(xs) -> list[float]:
    """Device scalars → floats in ONE device-to-host transfer."""
    if not xs:
        return []
    return torch.stack([torch.as_tensor(x).reshape(()) for x in xs]).cpu().tolist()
