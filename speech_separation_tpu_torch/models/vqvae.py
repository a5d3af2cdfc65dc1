"""The VQ-VAE audio-codec family (counterpart of ``models/vqvae.py``): five
topologies over raw 1-D audio, each returning ``(reconstruction,
aux_losses)`` so one train step applies ``loss + sum(aux_losses)``:

- :class:`VqVaeGumbel`   — v1: sample-level ``[B, T, 1]``, five stride-2
  convs into ``latent_dim`` logits, Gumbel-Softmax, a dense codebook lookup,
  the mirrored transposed-conv decoder, KL-to-uniform aux loss;
- :class:`VqVaeCodebook` — v2: frame-stacked ``[B, K, 40]``, two codebook VQs
  with a U-style concat, stride-1 convs;
- :class:`VqVaeT2`       — a stride-2 U-skip, tanh convs, one VQ;
- :class:`VqVaeT3`       — three stride-2 encoders into one VQ, long skip;
- :class:`VqVaeT3Tok`    — t3 with the skip quantized too, both levels by
  residual VQ cascades, so the two code streams alone reconstruct the audio.

``codes`` / ``decode_codes`` expose a model as a tokenizer where JAX's does.
Every nearest-code search runs the ``nearest_code`` CUDA kernel on a GPU
(its plain version where ``ops.dispatch.use_plain`` says). Submodules carry
the flax names and layouts (Conv and ConvTranspose kernels ``[width, in,
out]``, Dense kernels ``[in, out]``), so ``weights.vqvae_state_dict`` is a
rename; activations are channels-last ``[B, T, C]``. flax's "SAME" padding with an even kernel is
asymmetric and differs between Conv and ConvTranspose; ``models.tasnet``'s
``conv_same`` and ``conv_transpose_same`` reproduce both.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import tasnet
from .tasnet import conv_same, conv_transpose_same
from .upit import Dense
from .vq import GumbelSoftmax, ResidualVectorQuantizer, VectorQuantizer, nearest_code_indices

__all__ = ["VqVaeGumbel", "VqVaeCodebook", "VqVaeT2", "VqVaeT3", "VqVaeT3Tok"]


class _Conv(tasnet._Conv):
    """flax ``nn.Conv`` (or, ``transpose=True``, ``nn.ConvTranspose``) with
    ``padding="SAME"`` over channels-last ``x``: ``kernel [width, in, out]``
    (lecun-normal, fan-in ``width · in``), ``bias [out]`` zeros."""

    def __init__(self, in_features: int, features: int, width: int, stride: int = 1,
                 transpose: bool = False, generator=None):
        super().__init__(width, in_features, features, generator)
        self.stride, self.transpose = stride, transpose

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            y = conv_transpose_same(x.transpose(1, 2), self.kernel, self.bias, self.stride)
            return y.transpose(1, 2)
        return conv_same(x, self.kernel, self.bias, self.stride)


class _Stack(nn.Module):
    """Width-4 stride-2 "SAME" convs (``conv_{i}``) or transposed convs
    (``deconv_{i}``), each followed by ReLU."""

    def __init__(self, in_features: int, features: Sequence[int], transpose: bool, generator=None):
        super().__init__()
        self.names = []
        for i, f in enumerate(features):
            name = f"{'deconv' if transpose else 'conv'}_{i}"
            self.add_module(name, _Conv(in_features, f, 4, 2, transpose, generator))
            self.names.append(name)
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = torch.relu(getattr(self, name)(x))
        return x


class VqVaeGumbel(nn.Module):
    """v1: Gumbel-Softmax categorical VAE over raw samples ``[B, T, 1]`` (T a
    multiple of 32); 5,148,897 parameters at ``latent_dim=1024``."""

    def __init__(self, latent_dim: int = 1024, kl_weight: float = 0.2, temperature: float = 0.5,
                 gumbel_hard: bool = False, *, generator: torch.Generator | None = None):
        super().__init__()
        self.latent_dim, self.kl_weight = latent_dim, kl_weight
        self.encoder = _Stack(1, [32, 128, 128, 256, 512], False, generator)
        self.logit = _Conv(512, latent_dim, 1, generator=generator)
        self.gumbel = GumbelSoftmax(temperature, gumbel_hard)
        self.sampled = Dense(latent_dim, latent_dim, generator=generator)  # codebook lookup
        self.decoder = _Stack(latent_dim, [512, 256, 128, 128, 32], True, generator)
        self.out = _Conv(32, 1, 1, transpose=True, generator=generator)

    def encode_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.logit(self.encoder(x))  # [B, T/32, latent_dim]

    def forward(
        self,
        x: torch.Tensor,
        *,
        deterministic: bool = False,
        temperature: float | torch.Tensor | None = None,
        kl_scale: float | torch.Tensor = 1.0,
        generator: torch.Generator | None = None,
    ):
        """``temperature`` and ``kl_scale`` anneal tau and warm up the KL
        weight during training (``make_vae_steps``' ``schedule``)."""
        logits = self.encode_logits(x)
        sample = self.gumbel(logits, deterministic=deterministic, temperature=temperature,
                             generator=generator)
        decoded = self.out(self.decoder(self.sampled(sample)))
        # KL to the uniform prior: Σ q (log q − log 1/K), summed over time and codes
        qy = torch.softmax(logits, dim=-1)
        log_qy = torch.log(qy + 1e-10)
        kl = torch.sum(qy * (log_qy - math.log(1.0 / self.latent_dim)), dim=(1, 2))
        aux = torch.mean(kl) * self.kl_weight * kl_scale
        return decoded, [aux]

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """Discrete code indices ``[B, T/32]`` (argmax over logits), int32."""
        return torch.argmax(self.encode_logits(x), dim=-1).to(torch.int32)

    def decode_codes(self, indices: torch.Tensor) -> torch.Tensor:
        one_hot = F.one_hot(indices.long(), self.latent_dim).to(self.sampled.kernel.dtype)
        return self.out(self.decoder(self.sampled(one_hot)))


class VqVaeCodebook(nn.Module):
    """v2: two-level codebook VQ over frame-stacked input ``[B, K, 40]``."""

    def __init__(self, embedding_dim: int = 64, num_embeddings: int = 256, frame_size: int = 40,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        d, g = embedding_dim, generator
        self.encoder1 = _Conv(frame_size, 32, 4, generator=g)
        self.encoder2 = _Conv(32, d, 4, generator=g)
        self.vq1 = VectorQuantizer(num_embeddings, d, generator=g)
        self.decoder1 = _Conv(d, d, 4, transpose=True, generator=g)
        self.encoder3 = _Conv(32 + d, d, 1, generator=g)
        self.vq2 = VectorQuantizer(num_embeddings, d, generator=g)
        self.decoder2 = _Conv(d, d, 4, transpose=True, generator=g)
        self.decoder3 = _Conv(2 * d, frame_size, 4, transpose=True, generator=g)

    def forward(self, x: torch.Tensor, *, deterministic: bool = False,
                generator: torch.Generator | None = None):
        del deterministic, generator
        e1 = torch.relu(self.encoder1(x))
        e2 = torch.relu(self.encoder2(e1))
        q1, aux1 = self.vq1(e2)
        d1 = torch.relu(self.decoder1(q1))
        e3 = torch.relu(self.encoder3(torch.cat([e1, d1], dim=-1)))
        q2, aux2 = self.vq2(e3)
        d2 = torch.relu(self.decoder2(q1))
        return self.decoder3(torch.cat([d2, q2], dim=-1)), [aux1, aux2]


class VqVaeT2(nn.Module):
    """t2: stride-2 U-skip codec, tanh conv front, one VQ bottleneck."""

    def __init__(self, embedding_dim: int = 64, num_embeddings: int = 512, frame_size: int = 40,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        d, g = embedding_dim, generator
        self.embedding_dim = d
        self.encoder1 = _Conv(frame_size, 128, 4, 2, generator=g)
        self.encoder2 = _Conv(128, d, 4, 2, generator=g)
        self.vq1 = VectorQuantizer(num_embeddings, d, generator=g)
        self.decoder1 = _Conv(d, 128, 4, 2, transpose=True, generator=g)
        self.decoder3 = _Conv(256, frame_size, 4, 2, transpose=True, generator=g)

    def forward(self, x: torch.Tensor, *, deterministic: bool = False,
                generator: torch.Generator | None = None):
        del deterministic, generator
        e1 = torch.tanh(self.encoder1(x))  # [B, K/2, 128]
        e2 = torch.tanh(self.encoder2(e1))  # [B, K/4, D]
        q1, aux = self.vq1(e2)
        d1 = torch.relu(self.decoder1(q1))  # [B, K/2, 128]
        return self.decoder3(torch.cat([e1, d1], dim=-1)), [aux]  # [B, K, 40]

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        e2 = torch.tanh(self.encoder2(torch.tanh(self.encoder1(x))))
        flat = e2.reshape(-1, self.embedding_dim)
        return nearest_code_indices(flat, self.vq1.embeddings).reshape(e2.shape[:-1])


class VqVaeT3(nn.Module):
    """t3: 3-level stride-2 bottleneck (8x frame downsample), long skip;
    193,000 parameters at the defaults."""

    def __init__(self, embedding_dim: int = 64, num_embeddings: int = 512, frame_size: int = 40,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        d, g = embedding_dim, generator
        self.embedding_dim = d
        self.encoder1 = _Conv(frame_size, 128, 4, 2, generator=g)
        self.encoder2 = _Conv(128, d, 4, 2, generator=g)
        self.encoder3 = _Conv(d, d, 4, 2, generator=g)
        self.vq1 = VectorQuantizer(num_embeddings, d, generator=g)
        self.decoder1 = _Conv(d, d, 4, 2, transpose=True, generator=g)
        self.decoder2 = _Conv(d, 128, 4, 2, transpose=True, generator=g)
        self.decoder3 = _Conv(256, frame_size, 4, 2, transpose=True, generator=g)

    def _encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        e1 = torch.tanh(self.encoder1(x))  # [B, K/2, 128]
        e2 = torch.tanh(self.encoder2(e1))  # [B, K/4, D]
        return e1, torch.tanh(self.encoder3(e2))  # [B, K/8, D]

    def _decode(self, q1: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
        d2 = torch.relu(self.decoder2(torch.relu(self.decoder1(q1))))  # [B, K/2, 128]
        return self.decoder3(torch.cat([e1, d2], dim=-1))  # [B, K, 40]

    def forward(self, x: torch.Tensor, *, deterministic: bool = False,
                generator: torch.Generator | None = None):
        del deterministic, generator
        e1, e3 = self._encode(x)
        q1, aux = self.vq1(e3)
        return self._decode(q1, e1), [aux]

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """Tokenise: code indices ``[B, K/8]``."""
        _, e3 = self._encode(x)
        flat = e3.reshape(-1, self.embedding_dim)
        return nearest_code_indices(flat, self.vq1.embeddings).reshape(e3.shape[:-1])

    def decode_codes(self, indices: torch.Tensor, e1: torch.Tensor) -> torch.Tensor:
        return self._decode(VectorQuantizer.lookup(self.vq1.embeddings, indices), e1)


class VqVaeT3Tok(nn.Module):
    """Tokenizer-grade t3: the e1 U-skip is quantized too, both levels by
    residual VQ cascades, so ``codes_deep [B, K/8, deep_depth]`` and
    ``codes_skip [B, K/2, skip_depth · skip_pq]`` alone determine the
    reconstruction: ``decode_codes(*codes(x))`` is ``forward``'s output."""

    def __init__(
        self,
        embedding_dim: int = 64,
        num_embeddings: int = 512,
        skip_embeddings: int = 512,
        deep_depth: int = 2,
        skip_depth: int = 2,
        skip_pq: int = 2,
        frame_size: int = 40,
        vq_init_scale: float = 0.5,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        d, g = embedding_dim, generator
        self.encoder1 = _Conv(frame_size, 128, 4, 2, generator=g)
        self.encoder2 = _Conv(128, d, 4, 2, generator=g)
        self.encoder3 = _Conv(d, d, 4, 2, generator=g)
        self.vq1 = ResidualVectorQuantizer(num_embeddings, d, depth=deep_depth,
                                           init_scale=vq_init_scale, generator=g)
        self.skip_proj = _Conv(128, d, 1, generator=g)
        self.vq2 = ResidualVectorQuantizer(skip_embeddings, d, depth=skip_depth, pq=skip_pq,
                                           init_scale=vq_init_scale, generator=g)
        self.skip_expand = _Conv(d, 128, 1, generator=g)
        self.decoder1 = _Conv(d, d, 4, 2, transpose=True, generator=g)
        self.decoder2 = _Conv(d, 128, 4, 2, transpose=True, generator=g)
        self.decoder3 = _Conv(256, frame_size, 4, 2, transpose=True, generator=g)

    def _encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        e1 = torch.tanh(self.encoder1(x))  # [B, K/2, 128]
        e2 = torch.tanh(self.encoder2(e1))  # [B, K/4, D]
        e3 = torch.tanh(self.encoder3(e2))  # [B, K/8, D]
        return torch.tanh(self.skip_proj(e1)), e3  # skip [B, K/2, D]

    def _decode(self, q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
        d2 = torch.relu(self.decoder2(torch.relu(self.decoder1(q1))))  # [B, K/2, 128]
        s = torch.relu(self.skip_expand(q2))  # [B, K/2, 128]
        return self.decoder3(torch.cat([s, d2], dim=-1))  # [B, K, 40]

    def forward(self, x: torch.Tensor, *, deterministic: bool = False,
                generator: torch.Generator | None = None):
        del deterministic, generator
        skip, e3 = self._encode(x)
        q1, aux1 = self.vq1(e3)
        q2, aux2 = self.vq2(skip)
        return self._decode(q1, q2), [aux1, aux2]

    def codes(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Tokenise: ``(codes_deep [B, K/8, d1], codes_skip [B, K/2, d2·pq])``."""
        skip, e3 = self._encode(x)
        return self.vq1.codes(e3), self.vq2.codes(skip)

    def decode_codes(self, codes_deep: torch.Tensor, codes_skip: torch.Tensor) -> torch.Tensor:
        """Waveform frames from the two code streams alone (no encoder)."""
        q1 = ResidualVectorQuantizer.lookup(self.vq1.embeddings, codes_deep)
        q2 = ResidualVectorQuantizer.lookup(self.vq2.embeddings, codes_skip)
        return self._decode(q1, q2)
