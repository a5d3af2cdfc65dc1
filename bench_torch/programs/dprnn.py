"""The system under test for ``dprnn`` configurations: the port's ``DPRNN``
with the benchmark's weights, served as ``cli separate`` serves a ``dprnn``
checkpoint (``models.dprnn.serving_fn``: the module's forward, its BiLSTM
recurrences in the ``lstm_recurrence`` kernel)."""

from __future__ import annotations

import torch

from speech_separation_tpu_torch.models.dprnn import DPRNN, serving_fn


def build(cfg: dict, weights: dict, device: torch.device) -> DPRNN:
    """The model, its parameters copied from ``weights`` (no init of its own)."""
    with torch.device("meta"):
        model = DPRNN(cfg["num_speakers"], cfg["enc_dim"], cfg["win"], cfg["bottleneck"],
                      cfg["hidden"], cfg["chunk"], cfg["blocks"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model.eval()


def separate_system(model: DPRNN, cfg: dict):
    """``separate(mix [B, samples], frame_lengths) -> [B, S, samples]``:
    ``serving_fn`` in the configuration's precision (``cli separate``, with
    ``--bf16`` for bf16)."""
    serve = serving_fn(model, bf16=cfg["precision"] == "bf16")

    def separate(mix: torch.Tensor, frame_lengths=None) -> torch.Tensor:
        return serve(mix.float())

    return separate
