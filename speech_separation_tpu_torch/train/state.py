"""Train state (counterpart of ``train/state.py``).

Everything a resumable run needs: the model (its parameters are the fp32
masters), the optimizer (moments, update count, schedule), the step counter
and the dropout generator. PyTorch updates the parameters in place, so
:meth:`TrainState.snapshot` copies the state to host memory where the JAX
loop keeps an immutable tree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch

from .optim import Adam, Schedule

__all__ = ["TrainState"]


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Adam
    generator: torch.Generator
    step: int = 0

    @classmethod
    def create(
        cls,
        model: torch.nn.Module,
        tx: Callable[[Iterable[torch.Tensor]], Adam],
        seed: int,
    ) -> "TrainState":
        """``tx`` builds the optimizer over the parameters (``train.optim``);
        the dropout generator lives on the model's device, seeded with ``seed``."""
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(seed)
        return cls(model, tx(model.parameters()), generator)

    @property
    def schedule(self) -> Schedule:
        return self.optimizer.schedule

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``, which it clears."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        return self

    def state_dict(self) -> dict[str, Any]:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self.step,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])

    def snapshot(self) -> dict[str, Any]:
        """A copy of :meth:`state_dict` in host memory, untouched by later steps."""
        return _to_cpu(self.state_dict())


def _to_cpu(tree):
    """Copy every tensor of a nested dict/list to host memory; rebuild the containers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree
