"""Separator models as ``nn.Module``s: the uPIT BLSTM and Conv-TasNet, and
Conv-TasNet's folded serving and kernel training paths."""

from .tasnet import ConvTasNet
from .tasnet_serving import cuda_apply, fused_apply, train_apply
from .upit import UPitBlstm

__all__ = ["ConvTasNet", "UPitBlstm", "cuda_apply", "fused_apply", "train_apply"]
