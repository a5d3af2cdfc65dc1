"""The yardstick against counts by hand from the widths."""

import importlib.util
import json
import math

import pytest
from conftest import ROOT

from bench_torch import counts, harness


def _ref(arch):
    spec = importlib.util.spec_from_file_location(f"ref_{arch}", ROOT / "bench_torch" / "reference" / f"{arch}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg(name):
    bench = harness.load_benchmark()
    return json.loads((ROOT / next(c["file"] for c in bench["configs"] if c["name"] == name)).read_text())


def test_upit_blstm_flops_a_frame_by_hand():
    # Dense 129x496; layer 1: 2 dirs x (496x1984 input + 496x1984 recurrent);
    # layers 2, 3: 2 dirs x (992x1984 + 496x1984); two heads 992x129; 2 a multiply-add
    dense = 129 * 496
    layer1 = 2 * (496 * 1984 + 496 * 1984)
    layer23 = 2 * 2 * (992 * 1984 + 496 * 1984)
    heads = 2 * 992 * 129
    assert _ref("upit_blstm").flops_per_frame(_cfg("upit_blstm")) == 2 * (dense + layer1 + layer23 + heads) == 32_129_888


def test_conv_tasnet_flops_a_frame_by_hand():
    # encoder 40x256; bottleneck 256x128; 14 blocks of 128x256 + 3x256 + 256x(128 + 128);
    # mask 128x512; decoder 2 speakers x 256x40
    block = 128 * 256 + 3 * 256 + 256 * (128 + 128)
    total = 40 * 256 + 256 * 128 + 14 * block + 128 * 512 + 2 * 256 * 40
    assert _ref("conv_tasnet").flops_per_frame(_cfg("conv_tasnet")) == 2 * total == 3_032_064


def test_conv_tasnet_is_a_row_of_the_papers_table():
    # Luo and Mesgarani, Table I: N=256, L=40, B=128, H=256, Sc=128, P=3, X=7, R=2 (1.5M)
    cfg = _cfg("conv_tasnet")
    keys = ("enc_dim", "win", "bottleneck", "hidden", "skip_channels", "kernel", "blocks", "repeats")
    assert tuple(cfg[k] for k in keys) == (256, 40, 128, 256, 128, 3, 7, 2)
    assert round(cfg["parameters"] / 1e5) == 15


@pytest.mark.parametrize("name,params", [("upit_blstm", 16_077_602), ("conv_tasnet", 1_532_318)])
def test_parameter_count_matches_the_config(name, params):
    cfg = _cfg(name)
    shapes = _ref(cfg["arch"]).param_shapes(cfg)
    assert sum(math.prod(s) for s in shapes.values()) == params == cfg["parameters"]


def test_frames_a_second():
    assert _ref("upit_blstm").frames(_cfg("upit_blstm"), 8000 * 10) == 626  # ceil((80,000 + 128) / 128)
    assert _ref("conv_tasnet").frames(_cfg("conv_tasnet"), 8000 * 10) == 4_000  # stride 20


def test_lstm_serving_bound_by_hand():
    b, t, h = 256, 501, 496
    flops = 2 * 2 * b * t * h * 4 * h
    nbytes = 4 * (2 * b * t * 4 * h + 2 * h * 4 * h + b * t * 2 * h)
    want = max(flops / 67e12, nbytes / 3.35e12)
    assert counts.lstm_serving_bound_s(b, t, h) == pytest.approx(want, rel=1e-12)
    assert want == flops / 67e12  # bound by operations, as PERF.md's row 2 (7.535 ms)
    assert 1e3 * want == pytest.approx(7.535, abs=1e-3)


def test_lstm_train_bounds_by_hand():
    b, t, h = 32, 501, 496
    flops = 2 * 2 * b * t * h * 4 * h
    assert 1e3 * counts.lstm_train_bound_s("forward", b, t, h) == pytest.approx(0.942, abs=1e-3)
    assert counts.lstm_train_bound_s("backward", b, t, h) == pytest.approx(flops / 67e12)
    with pytest.raises(ValueError):
        counts.lstm_train_bound_s("sideways", b, t, h)


@pytest.mark.parametrize("batch,want", [(1, [1]), (184, [184]), (256, [256]), (300, [150, 150]),
                                        (513, [171, 171, 171])])
def test_row_slices(batch, want):
    assert counts.row_slices(batch) == want
