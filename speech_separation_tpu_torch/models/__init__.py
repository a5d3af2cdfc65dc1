"""Models as ``nn.Module``s: the uPIT BLSTM, Conv-TasNet, DPRNN-TasNet and
SepFormer separators, with Conv-TasNet's folded serving and kernel training
paths, and the VQ-VAE codec family with its quantizers."""

from .dprnn import DPRNN
from .sepformer import SepFormer
from .tasnet import ConvTasNet
from .tasnet_serving import cuda_apply, fused_apply, train_apply
from .upit import UPitBlstm
from .vq import (
    GumbelSoftmax,
    ResidualVectorQuantizer,
    VectorQuantizer,
    gumbel_softmax,
    nearest_code_indices,
)
from .vqvae import VqVaeCodebook, VqVaeGumbel, VqVaeT2, VqVaeT3, VqVaeT3Tok

__all__ = [
    "ConvTasNet",
    "DPRNN",
    "GumbelSoftmax",
    "ResidualVectorQuantizer",
    "SepFormer",
    "UPitBlstm",
    "VectorQuantizer",
    "VqVaeCodebook",
    "VqVaeGumbel",
    "VqVaeT2",
    "VqVaeT3",
    "VqVaeT3Tok",
    "cuda_apply",
    "fused_apply",
    "gumbel_softmax",
    "nearest_code_indices",
    "train_apply",
]
