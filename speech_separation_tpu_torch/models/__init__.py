"""Models as ``nn.Module``s: the uPIT BLSTM, Conv-TasNet, DPRNN-TasNet,
SepFormer and TF-GridNet separators, with Conv-TasNet's folded serving and kernel training
paths, and the VQ-VAE codec family with its quantizers."""

from .dprnn import DPRNN
from .sepformer import SepFormer
from .tasnet import ConvTasNet
from .tasnet_serving import cuda_apply, fused_apply, train_apply
from .tfgridnet import TFGridNet
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
    "TFGridNet",
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
