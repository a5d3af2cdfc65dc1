"""The operand roundings the controls compute in."""

import pytest
import torch

from bench_torch.precision import rounding


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0 + one_ulp / 2 - 2 ** -20, 1.0 + one_ulp / 2 + 2 ** -20, 1.0 + 2 ** -12, -3.0])
    got = rounding("tf32")(x)
    assert got.tolist() == [1.0, 1.0 + one_ulp, 1.0, -3.0]
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(0))
    rel = ((rounding("tf32")(y) - y).abs() / y.abs()).max().item()
    assert 2 ** -13 < rel <= 2 ** -11


@pytest.mark.parametrize("name,worst", [("bf16", 2 ** -8), ("fp8", 2 ** -4)])
def test_bf16_and_fp8_errors(name, worst):
    y = torch.randn(10_000, generator=torch.Generator().manual_seed(1))
    big = y.abs() > 0.1  # fp8's per-tensor scale leaves small values coarser
    rel = ((rounding(name)(y) - y).abs() / y.abs())[big].max().item()
    assert worst / 4 < rel <= worst


def test_unknown_precision_is_refused():
    with pytest.raises(ValueError):
        rounding("fp4")
