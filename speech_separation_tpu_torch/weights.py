"""JAX parameter trees → the port's ``state_dict``s.

The port's modules keep the flax names and layouts (stacked BiLSTM ``cells``
with a leading direction axis of 2, ``Dense`` kernels ``[in, out]``), so the
conversion is a rename: the nested path joined with dots. Pass the tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``); this
module imports no JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["flatten_params", "upit_blstm_state_dict"]


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


def upit_blstm_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """State dict for ``models.upit.UPitBlstm`` from a JAX ``UPitBlstm`` tree.

    Accepts the tree with or without its top-level ``"params"`` collection.
    """
    if "params" in params:
        params = params["params"]
    return flatten_params(params)
