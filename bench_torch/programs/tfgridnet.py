"""The system under test for ``tfgridnet`` configurations: the port's
``TFGridNet`` with the benchmark's weights, served as ``cli separate --bf16``
serves a ``tfgridnet`` checkpoint (``models.tfgridnet.serving_fn``: the
module's forward, its products in bf16, its recurrences in the serving LSTM
kernel and its attention in the wide-head scores kernel)."""

from __future__ import annotations

import torch

from speech_separation_tpu_torch.models.tfgridnet import TFGridNet, serving_fn


def build(cfg: dict, weights: dict, device: torch.device) -> TFGridNet:
    """The model, its parameters copied from ``weights`` (no init of its own)."""
    with torch.device("meta"):
        model = TFGridNet(cfg["num_speakers"], cfg["n_fft"], cfg["hop"], cfg["d_model"],
                          cfg["blocks"], cfg["kernel"], cfg["hidden"], cfg["heads"], cfg["qk_dim"],
                          cfg["eps"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model.eval()


def separate_system(model: TFGridNet, cfg: dict):
    """``separate(mix [B, samples], frame_lengths) -> [B, S, samples]``:
    ``serving_fn`` in the configuration's precision (``cli separate``, with
    ``--bf16`` for bf16)."""
    serve = serving_fn(model, bf16=cfg["precision"] == "bf16")

    def separate(mix: torch.Tensor, frame_lengths=None) -> torch.Tensor:
        return serve(mix.float())

    return separate
