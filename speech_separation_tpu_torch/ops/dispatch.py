"""The one choice between a CUDA kernel and its plain PyTorch version.

Every CUDA wrapper in ``ops/`` asks :func:`use_plain` before it launches:
a tensor on the CPU, or a call inside :func:`plain_versions`, runs the plain
version; any other tensor runs the kernel (or the wrapper raises). The
switch is off by default and scoped to the context that entered it, so the
layers above ``ops/`` never carry the choice. An autograd function decides
in its forward and keeps the answer for its backward, which autograd may
run on another thread.

:func:`fixed_shape_calls` is the one hint a caller gives the serving paths
beside it: the calls inside repeat one input shape, call after call (a
streaming engine's window), so a path may capture its launches once as a
CUDA graph and replay them (``models/tasnet_serving.py::cuda_apply``). It is
off by default and scoped the same way.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator

import torch

__all__ = ["fixed_shape_calls", "in_fixed_shape_calls", "plain_versions", "use_plain"]

_PLAIN = contextvars.ContextVar("plain_versions", default=False)
_FIXED = contextvars.ContextVar("fixed_shape_calls", default=False)


@contextlib.contextmanager
def plain_versions(on: bool = True) -> Iterator[None]:
    """Run every kernel's plain version (``on=False``: the kernels) inside
    the block, on any device; the setting before it is restored on exit."""
    token = _PLAIN.set(on)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its plain version."""
    return t.device.type == "cpu" or _PLAIN.get()


@contextlib.contextmanager
def fixed_shape_calls() -> Iterator[None]:
    """Declare that the calls inside the block are one of a run of calls on
    one input shape; the setting before it is restored on exit."""
    token = _FIXED.set(True)
    try:
        yield
    finally:
        _FIXED.reset(token)


def in_fixed_shape_calls() -> bool:
    """Whether the caller declared :func:`fixed_shape_calls`."""
    return _FIXED.get()
