"""The system under test for ``sepformer`` configurations: the port's
``SepFormer`` with the benchmark's weights, served as ``cli separate`` serves
a ``sepformer`` checkpoint (``models.sepformer.serving_fn``: the module's
forward, its products in bf16 and its attention in SDPA's flash kernel)."""

from __future__ import annotations

import torch

from speech_separation_tpu_torch.models.sepformer import SepFormer, serving_fn


def build(cfg: dict, weights: dict, device: torch.device) -> SepFormer:
    """The model, its parameters copied from ``weights`` (no init of its own)."""
    with torch.device("meta"):
        model = SepFormer(cfg["num_speakers"], cfg["enc_dim"], cfg["win"], cfg["d_model"],
                          cfg["heads"], cfg["ffn"], cfg["layers"], cfg["chunk"], cfg["blocks"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model.eval()


def separate_system(model: SepFormer, cfg: dict):
    """``separate(mix [B, samples], frame_lengths) -> [B, S, samples]``:
    ``serving_fn`` in the configuration's precision (``cli separate``, with
    ``--bf16`` for bf16)."""
    serve = serving_fn(model, bf16=cfg["precision"] == "bf16")

    def separate(mix: torch.Tensor, frame_lengths=None) -> torch.Tensor:
        return serve(mix.float())

    return separate
