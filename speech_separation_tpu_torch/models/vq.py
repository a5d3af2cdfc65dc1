"""Discrete-latent layers (counterpart of ``models/vq.py``): Gumbel-Softmax
sampling and codebook vector quantization.

- :func:`gumbel_softmax`: logits plus ``-log(-log U)`` noise, softmax at a
  temperature; ``hard`` adds the straight-through one-hot;
- :class:`VectorQuantizer`: codebook ``embeddings [D, K]`` (uniform
  ``±init_scale``), nearest code, lookup ``codebook.T[indices]``, auxiliary
  loss ``0.5 · (β·commitment + codebook)``, straight-through output;
- :class:`ResidualVectorQuantizer`: ``embeddings [depth, pq, D/pq, K]``, each
  stage quantizing the residual the earlier stages left, each stage's vector
  split into ``pq`` sub-vectors with codebooks of their own; indices are
  stage-major.

Every nearest-code search goes through :func:`nearest_code_indices`, which
launches the ``nearest_code`` CUDA kernel on a GPU tensor (its plain version
where ``ops.dispatch.use_plain`` says): one launch a residual stage, every
product-quantisation group of it in one grouped call that reads the
residual's column slices in place. The JAX flag ``use_pallas`` is not carried
over: both of its branches compute the same function.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.vq_cuda import nearest_code

__all__ = [
    "gumbel_softmax",
    "GumbelSoftmax",
    "VectorQuantizer",
    "ResidualVectorQuantizer",
    "nearest_code_indices",
]


def gumbel_softmax(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    temperature: float | torch.Tensor = 0.5,
    hard: bool = False,
    eps: float = 1e-20,
    uniform: torch.Tensor | None = None,
) -> torch.Tensor:
    """A Gumbel-Softmax sample of ``logits`` over the last axis. ``uniform``
    holds the U(0, 1) draws; where it is ``None`` they come from ``generator``."""
    if uniform is None:
        uniform = torch.rand(logits.shape, generator=generator, device=logits.device,
                             dtype=logits.dtype)
    gumbel = -torch.log(-torch.log(uniform + eps) + eps)
    y = torch.softmax((logits + gumbel) / temperature, dim=-1)
    if hard:
        y_hard = (y == y.amax(dim=-1, keepdim=True)).to(y.dtype)
        y = (y_hard - y).detach() + y
    return y


class GumbelSoftmax(nn.Module):
    def __init__(self, temperature: float = 0.5, hard: bool = False):
        super().__init__()
        self.temperature, self.hard = temperature, hard

    def forward(
        self,
        logits: torch.Tensor,
        *,
        deterministic: bool = False,
        temperature: float | torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        if deterministic:
            # multi-hot where the largest logits tie exactly, as in JAX
            return (logits == logits.amax(dim=-1, keepdim=True)).to(logits.dtype)
        tau = self.temperature if temperature is None else temperature
        return gumbel_softmax(logits, generator, tau, self.hard)


def nearest_code_indices(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``argmin_k ‖flat_n − codebook[:, k]‖²`` for ``flat [N, D]``,
    ``codebook [D, K]``: int32 ``[N]``; for ``flat [N, G·S]``, ``codebook
    [G, S, K]`` the same per group of ``S`` columns: int32 ``[N, G]``. Through
    the ``nearest_code`` kernel (or its plain version); ``flat`` is copied
    only where its columns are not contiguous."""
    flat, codebook = flat.detach(), codebook.detach()
    if flat.stride(-1) != 1 or flat.stride(0) < flat.shape[-1]:
        flat = flat.contiguous()
    return nearest_code(flat, codebook.contiguous())


def _uniform_(param: torch.Tensor, scale: float, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        param.uniform_(-scale, scale, generator=generator)


def _aux_loss(q: torch.Tensor, x: torch.Tensor, beta: float) -> torch.Tensor:
    """``0.5 · (β·mean((sg(q) − x)²) + mean((q − sg(x))²))``."""
    commitment = beta * torch.mean(torch.square(q.detach() - x))
    codebook_loss = torch.mean(torch.square(q - x.detach()))
    return 0.5 * (commitment + codebook_loss)


class VectorQuantizer(nn.Module):
    """Codebook VQ with the straight-through estimator; ``forward`` returns
    ``(quantized, aux_loss)``."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        beta: float = 0.25,
        init_scale: float = 0.05,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_embeddings, self.embedding_dim, self.beta = num_embeddings, embedding_dim, beta
        self.embeddings = nn.Parameter(torch.empty(embedding_dim, num_embeddings))
        _uniform_(self.embeddings, init_scale, generator)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = x.reshape(-1, self.embedding_dim)
        indices = nearest_code_indices(flat, self.embeddings)
        quantized = self.lookup(self.embeddings, indices).reshape(x.shape)
        aux = _aux_loss(quantized, x, self.beta)
        return x + (quantized - x).detach(), aux

    @staticmethod
    def lookup(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """Decode code indices ``[...]`` → embeddings ``[..., D]``."""
        return codebook.T[indices]


class ResidualVectorQuantizer(nn.Module):
    """Multi-stage residual VQ with optional product quantization; ``forward``
    returns ``(quantized, aux_loss)``, ``codes`` the stage-major indices
    ``[..., depth · pq]``."""

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        depth: int = 2,
        pq: int = 1,
        beta: float = 0.25,
        init_scale: float = 0.5,
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if embedding_dim % pq:
            raise ValueError(f"embedding_dim {embedding_dim} % pq {pq} != 0")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.depth, self.pq, self.beta = depth, pq, beta
        self.embeddings = nn.Parameter(
            torch.empty(depth, pq, embedding_dim // pq, num_embeddings)
        )
        _uniform_(self.embeddings, init_scale, generator)

    @property
    def num_streams(self) -> int:
        return self.depth * self.pq

    def _quantize_stage(self, residual: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Nearest codes per sub-vector, one grouped search for the stage:
        ``[N, D]`` → (q ``[N, D]``, indices ``[N, pq]``)."""
        indices = nearest_code_indices(residual, self.embeddings[d])
        parts = [self.embeddings[d, g].T[indices[:, g]] for g in range(self.pq)]
        return torch.cat(parts, dim=1), indices

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = x.reshape(-1, self.embedding_dim)
        residual = flat
        q_sum = torch.zeros_like(flat)
        aux = flat.new_zeros(())
        for d in range(self.depth):
            q_d, _ = self._quantize_stage(residual.detach(), d)
            aux = aux + _aux_loss(q_d, residual, self.beta)
            residual = residual - q_d.detach()
            q_sum = q_sum + q_d.detach()
        out = flat + (q_sum - flat).detach()  # straight-through
        return out.reshape(x.shape), aux

    def codes(self, x: torch.Tensor) -> torch.Tensor:
        """Indices ``[..., depth · pq]`` (stage-major) for latents ``[..., D]``."""
        flat = x.reshape(-1, self.embedding_dim)
        residual = flat
        out = []
        for d in range(self.depth):
            q_d, idx = self._quantize_stage(residual, d)
            out.append(idx)
            residual = residual - q_d
        return torch.cat(out, dim=-1).reshape(*x.shape[:-1], self.num_streams)

    @staticmethod
    def lookup(codebooks: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
        """``codebooks [depth, pq, D/pq, K]``, ``indices [..., depth·pq]``
        (stage-major) → ``[..., D]``."""
        depth, pq = codebooks.shape[0], codebooks.shape[1]
        total = 0
        for d in range(depth):
            parts = [codebooks[d, g].T[indices[..., d * pq + g]] for g in range(pq)]
            total = total + torch.cat(parts, dim=-1)
        return total
