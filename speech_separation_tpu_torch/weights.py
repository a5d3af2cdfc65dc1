"""JAX parameter trees ↔ the port's ``state_dict``s.

The port's modules keep the flax names and layouts (``UPitBlstm``: stacked
BiLSTM ``cells`` with a leading direction axis of 2, ``Dense`` kernels ``[in,
out]``; ``ConvTasNet``: Conv kernels ``[width, in/groups, out]``,
ConvTranspose ``[win, in, out]``; the VQ-VAE codecs: Conv and ConvTranspose
``[width, in, out]``, codebooks ``[D, K]`` and residual VQ ``[depth, pq,
D/pq, K]``), so the conversion is a rename both ways:
the nested path joined with dots, and a dotted name split back into nested
dicts. Pass and receive trees as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); this module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = [
    "flatten_params",
    "state_dict_from_params",
    "params_from_state_dict",
    "upit_blstm_state_dict",
    "upit_blstm_params",
    "convtasnet_state_dict",
    "convtasnet_params",
    "vqvae_state_dict",
    "vqvae_params",
    "load_params_npz",
]


def flatten_params(params: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{"a": {"b": x}}`` → ``{"a.b": tensor(x)}`` (float32 arrays stay float32)."""
    flat: dict[str, torch.Tensor] = {}
    for name, value in params.items():
        key = f"{prefix}{name}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, key + "."))
        else:
            flat[key] = torch.from_numpy(np.array(value))
    return flat


def state_dict_from_params(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict of the port's module from the JAX module's parameter tree,
    with or without its top-level ``"params"`` collection."""
    if "params" in params:
        params = params["params"]
    return flatten_params(params)


def params_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The JAX parameter tree (without the ``"params"`` collection) from a
    state dict: ``{"a.b": tensor}`` → ``{"a": {"b": ndarray}}``, float32 numpy
    arrays on the host."""
    tree: dict = {}
    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value.detach().to("cpu", torch.float32).numpy()
    return tree


def load_params_npz(path) -> dict[str, torch.Tensor]:
    """State dict from an ``.npz`` of flax parameter paths joined by dots
    (``scripts/export_vae_params.py`` writes one), read with numpy alone."""
    with np.load(path) as payload:
        return flatten_params({name: payload[name] for name in payload.files})


# models.upit.UPitBlstm, models.tasnet.ConvTasNet and the models.vqvae codecs
# (the residual VQ embeddings stay one 4-D tensor): the same rename
upit_blstm_state_dict = convtasnet_state_dict = vqvae_state_dict = state_dict_from_params
upit_blstm_params = convtasnet_params = vqvae_params = params_from_state_dict
