"""Separator models as ``nn.Module``s: the uPIT BLSTM and Conv-TasNet, and
Conv-TasNet's folded serving paths."""

from .tasnet import ConvTasNet
from .tasnet_serving import cuda_apply, fused_apply
from .upit import UPitBlstm

__all__ = ["ConvTasNet", "UPitBlstm", "cuda_apply", "fused_apply"]
