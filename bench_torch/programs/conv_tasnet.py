"""The system under test for ``conv_tasnet`` configurations: the port's
``ConvTasNet`` with the benchmark's weights, served as ``cli separate
--kernel pallas`` serves it (``models.tasnet_serving.cuda_apply``: the TCN
trunk in the ``tcn_trunk`` kernel, bf16)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from speech_separation_tpu_torch.models.tasnet import ConvTasNet
from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply


def build(cfg: dict, weights: dict, device: torch.device) -> ConvTasNet:
    """The model, its parameters copied from ``weights`` (no init of its own).
    The port's skip outputs are as wide as its bottleneck (Sc = B)."""
    if cfg["skip_channels"] != cfg["bottleneck"]:
        raise ValueError(f"the port's ConvTasNet has Sc = B; the configuration has Sc = "
                         f"{cfg['skip_channels']}, B = {cfg['bottleneck']}")
    with torch.device("meta"):
        model = ConvTasNet(cfg["num_speakers"], cfg["enc_dim"], cfg["win"], cfg["bottleneck"],
                           cfg["hidden"], cfg["kernel"], cfg["blocks"], cfg["repeats"],
                           cfg["causal"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model.eval()


def separate_system(model: ConvTasNet, cfg: dict):
    """``separate(mix [B, samples], frame_lengths) -> [B, S, samples]``: the
    mix padded to the encoder stride, ``cuda_apply``, the padding trimmed
    (``cli._separate_time_domain`` under ``--kernel pallas``)."""
    stride = cfg["win"] // 2

    @torch.inference_mode()
    def separate(mix: torch.Tensor, frame_lengths=None) -> torch.Tensor:
        orig = mix.shape[1]
        est = cuda_apply(model, F.pad(mix.float(), (0, (-orig) % stride)))
        return est[:, :, :orig]

    return separate


def stream_apply(model: ConvTasNet, cfg: dict, device: torch.device):
    """The window function ``cli separate --kernel pallas
    --streaming-hop-seconds`` hands ``StreamingSeparator``: a CPU window
    ``[1, samples]`` moved to the device, served, returned on the device."""
    served = separate_system(model, cfg)

    @torch.inference_mode()
    def apply(window: torch.Tensor) -> torch.Tensor:
        return served(window.to(device))

    return apply
