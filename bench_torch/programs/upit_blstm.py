"""The system under test for ``upit_blstm`` configurations: the port's
``UPitBlstm`` with the benchmark's weights, entered as ``cli separate`` and
``cli train --workload upit`` enter it."""

from __future__ import annotations

import copy

import torch

from speech_separation_tpu_torch import train
from speech_separation_tpu_torch.models.upit import UPitBlstm
from speech_separation_tpu_torch.separate.pipeline import make_separate_fn


def build(cfg: dict, weights: dict, device: torch.device) -> UPitBlstm:
    """The model, its parameters copied from ``weights`` (no init of its own)."""
    with torch.device("meta"):
        model = UPitBlstm(cfg["input_size"], cfg["output_size"], cfg["hidden"], cfg["num_layers"],
                          cfg["num_speakers"], cfg["dropout"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


def separate_system(model: UPitBlstm, cfg: dict):
    """``separate(mix [B, samples], frame_lengths [B]) -> [B, S, samples']``:
    ``separate.pipeline.make_separate_fn``, as ``separate_directory`` runs it."""
    return make_separate_fn(model, cfg["stft_size"], cfg["stft_shift"], cfg["num_speakers"])


class Trainer:
    """``make_upit_waveform_steps``' train step on a ``TrainState`` with
    ``exponential_decay_adam``, as ``cli train`` builds them (fp32)."""

    def __init__(self, model: UPitBlstm, cfg: dict, seed: int):
        tx = train.exponential_decay_adam(cfg["learning_rate"], cfg["lr_decay_steps"],
                                          cfg["lr_decay_rate"])
        self.state = train.TrainState.create(model, tx, int(seed))
        self.train_step, _ = train.make_upit_waveform_steps(
            model, cfg["stft_size"], cfg["stft_shift"], cfg["num_speakers"])

    def step(self, mix, sources, frame_lengths) -> torch.Tensor:
        self.state, loss = self.train_step(self.state, mix, sources, frame_lengths)
        return loss

    def first_grad_norms(self) -> dict[str, float]:
        """Each leaf's gradient norm, worked out from Adam's first moment
        after one step (0 where the optimizer holds none)."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["b1"]
        return {name: (opt.state[p]["mu"] / (1.0 - b1)).double().norm().item()
                if "mu" in opt.state[p] else 0.0
                for name, p in self.state.model.named_parameters()}

    def parameters(self) -> dict[str, torch.Tensor]:
        return dict(self.state.model.named_parameters())

    def snapshot(self):
        return (copy.deepcopy(self.state.model.state_dict()),
                copy.deepcopy(self.state.optimizer.state_dict()), self.state.step)

    def restore(self, snap) -> None:
        model, optimizer, step = snap
        self.state.model.load_state_dict(model)
        self.state.optimizer.load_state_dict(optimizer)
        self.state.step = step
