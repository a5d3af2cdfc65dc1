"""Optimisers and schedules (counterpart of ``train/optim.py``, optax there).

- uPIT models: Adam on an exponential-decay schedule — initial 1e-3, decay
  rate 0.96 every 20 steps, staircase (``uPIT_baseline.ipynb`` cell 27);
- :func:`cosine_adam`: warmup plus cosine decay for corpus-scale runs;
- :func:`adam`: a constant rate;
- :func:`nadam`: ``optax.nadam`` at a constant rate (the VQ-VAE codecs).

:class:`Adam` computes what ``optax.chain(clip_by_global_norm(c), adam(s))``
(or, ``nesterov=True``, ``optax.nadam``)
computes, which differs from ``torch.optim.Adam`` and
``torch.nn.utils.clip_grad_norm_`` in three places: clipping scales by
``max_norm / norm`` with no ``1e-6`` added to the norm; the schedule is read
at the update count *before* the update (step 0 runs at the initial rate);
``eps`` is added outside the square root of the bias-corrected second moment.
Each factory returns a callable that builds the optimizer over parameters,
as an optax transformation is initialised over a parameter tree.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Iterable

import numpy as np
import torch

__all__ = [
    "Adam",
    "Schedule",
    "exponential_decay",
    "warmup_cosine_decay",
    "adam",
    "nadam",
    "exponential_decay_adam",
    "cosine_adam",
]

Schedule = Callable[[int], float]


def exponential_decay(
    init_value: float, transition_steps: int, decay_rate: float, staircase: bool = True
) -> Schedule:
    """``optax.exponential_decay``: ``init · rate ** (count / steps)``, floored if staircase."""

    def schedule(count: int) -> float:
        p = count / transition_steps
        return init_value * decay_rate ** (math.floor(p) if staircase else p)

    return schedule


def warmup_cosine_decay(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear warmup from ``init_value``
    to ``peak_value``, then cosine decay to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init_value + (peak_value - init_value) * count / warmup_steps
        if cosine_steps <= 0:
            return peak_value
        done = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * done / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


class Adam(torch.optim.Optimizer):
    """Adam with optax's semantics, optional global-norm clipping ahead of it.

    The update count lives in each parameter group (``"count"``), so it
    travels with ``state_dict``; the schedule is code and does not.
    """

    def __init__(
        self,
        params: Iterable[torch.Tensor],
        schedule: Schedule,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        grad_clip_norm: float = 0.0,
        nesterov: bool = False,
    ):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps, count=0))
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.nesterov = nesterov

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        scale = None
        if self.grad_clip_norm > 0 and grads:
            norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
            scale = (norm < self.grad_clip_norm, norm)
        for group in self.param_groups:
            count = group["count"]
            lr = self.schedule(count)
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            # bias corrections in float32, as optax computes them: 1 - 0.999**1
            # is 1.3e-5 away from its float64 value once 0.999 is rounded
            c1, c2 = (float(np.float32(1) - np.float32(b) ** (count + 1)) for b in (b1, b2))
            c1_next = float(np.float32(1) - np.float32(b1) ** (count + 2))
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if scale is not None:
                    keep, norm = scale
                    g = torch.where(keep, g, g / norm * self.grad_clip_norm)
                state = self.state[p]
                if not state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.mul_(b1).add_((1.0 - b1) * g)
                nu.mul_(b2).add_((1.0 - b2) * (g * g))
                if self.nesterov:
                    # optax's scale_by_adam(nesterov=True): the moment corrected
                    # one step ahead, blended with the corrected gradient
                    mu_hat = b1 * (mu / c1_next) + (1.0 - b1) * (g / c1)
                else:
                    mu_hat = mu / c1
                update = mu_hat / (torch.sqrt(nu / c2) + eps)
                p.add_(update * -lr)
            group["count"] = count + 1


def adam(learning_rate: float = 1e-4, grad_clip_norm: float = 0.0):
    return functools.partial(
        Adam, schedule=lambda count: learning_rate, grad_clip_norm=grad_clip_norm
    )


def nadam(learning_rate: float = 1e-3, grad_clip_norm: float = 0.0):
    """``optax.nadam``: Adam with Nesterov momentum (the codecs t2, t3, t3tok)."""
    return functools.partial(
        Adam, schedule=lambda count: learning_rate, grad_clip_norm=grad_clip_norm, nesterov=True
    )


def exponential_decay_adam(
    initial_learning_rate: float = 1e-3,
    decay_steps: int = 20,
    decay_rate: float = 0.96,
    staircase: bool = True,
    grad_clip_norm: float = 0.0,
):
    schedule = exponential_decay(initial_learning_rate, decay_steps, decay_rate, staircase)
    return functools.partial(Adam, schedule=schedule, grad_clip_norm=grad_clip_norm)


def cosine_adam(
    peak_learning_rate: float = 1e-3,
    total_steps: int = 10_000,
    warmup_steps: int = 0,
    end_scale: float = 0.05,
    grad_clip_norm: float = 0.0,
):
    """Adam on warmup plus cosine decay to ``end_scale × peak`` at ``total_steps``."""
    schedule = warmup_cosine_decay(
        0.0 if warmup_steps else peak_learning_rate,
        peak_learning_rate,
        warmup_steps,
        max(total_steps, warmup_steps + 1),
        end_scale * peak_learning_rate,
    )
    return functools.partial(Adam, schedule=schedule, grad_clip_norm=grad_clip_norm)
