"""Rounding of a product's operands, so that the plain references can also
compute in a lower precision than the one a configuration states: the
controls that the comparison deciding ``correct`` has to fail.

- ``fp64``: everything in float64, a witness above the reference;
- ``fp32``: no rounding (the reference itself; TF32 is off in the process);
- ``tf32``: each operand rounded to nearest even at TF32's 10 mantissa bits,
  products accumulated in fp32, as a tensor core's TF32 mode does;
- ``bf16``: each operand rounded to bfloat16, accumulated in fp32;
- ``fp8``: each operand scaled by its tensor's largest magnitude to the
  float8 e4m3 range (448), rounded to e4m3 and scaled back: per-tensor
  scaled fp8, accumulated in fp32.

The same rounding on the CPU and on the card, so a CPU test sees what a
chip run sees.
"""

from __future__ import annotations

from typing import Callable

import torch

_E4M3_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & -8192  # clear the low 13 of 23 mantissa bits
    return rounded.view(torch.float32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    scale = x.abs().amax().clamp_min(1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _fp32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _fp64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


ROUNDINGS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "fp64": _fp64, "fp32": _fp32, "tf32": _tf32, "bf16": _bf16, "fp8": _fp8,
}


def dtype(name: str) -> torch.dtype:
    """The dtype a reference computes in at precision ``name``: float64 for
    ``fp64`` (a witness above the reference), else float32."""
    rounding(name)
    return torch.float64 if name == "fp64" else torch.float32


def rounding(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The operand rounding of precision ``name``."""
    try:
        return ROUNDINGS[name]
    except KeyError:
        raise ValueError(f"unknown precision {name!r} (one of {', '.join(ROUNDINGS)})") from None
