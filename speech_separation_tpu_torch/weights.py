"""JAX parameter trees ↔ the port's ``state_dict``s.

The port's modules keep the flax names and layouts (``UPitBlstm``: stacked
BiLSTM ``cells`` with a leading direction axis of 2, ``Dense`` kernels ``[in,
out]``; ``ConvTasNet``: Conv kernels ``[width, in/groups, out]``,
ConvTranspose ``[win, in, out]``), so the conversion is a rename both ways:
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


# models.upit.UPitBlstm and models.tasnet.ConvTasNet: the same rename
upit_blstm_state_dict = convtasnet_state_dict = state_dict_from_params
upit_blstm_params = convtasnet_params = params_from_state_dict
