"""CPU tests of the benchmark at toy sizes: the program's kernels run their
plain versions on the CPU, the references run as on the card."""

import dataclasses
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_torch import harness  # noqa: E402

# toy widths (the STFT keeps its 129 bins) and toy traffic, same keys
TINY_CFG = {
    "upit_blstm": {"hidden": 8, "num_layers": 1},
    "conv_tasnet": {"enc_dim": 16, "bottleneck": 8, "skip_channels": 8, "hidden": 16, "blocks": 3},
}
TINY_TRAFFIC = {
    "separate": {"utterances": 6, "batch": 3, "min_seconds": 0.2, "max_seconds": 0.6,
                 "pad_quantum_seconds": 0.1},
    "train": {"utterances": 6, "batch": 2, "min_seconds": 0.2, "max_seconds": 0.6,
              "pad_quantum_seconds": 0.1},
    "stream": {"streams": 2, "stream_seconds": 1.0, "hop_seconds": 0.1, "context_seconds": 0.2},
}


def tiny_cell(workload: str) -> harness.Cell:
    """The cell as ``BENCHMARK.json`` names it, at toy widths and traffic."""
    cell = harness.Cell.find(workload)
    return dataclasses.replace(
        cell,
        cfg={**cell.cfg, **TINY_CFG[cell.cfg["arch"]]},
        traffic={**cell.traffic, **TINY_TRAFFIC[cell.traffic["driver"]]},
    )


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
