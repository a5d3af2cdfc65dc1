"""The yardstick: the card's peaks and the least time each kernel could take.

A bound is the larger of the compulsory bytes over the HBM bandwidth and the
needed operations over the peak of their type, per launch, from the launch's
shapes. The arithmetic is copied from ``chip_smoke.py`` (``bound`` and the
LSTM bounds of its phases 5 and 8), which set the "Bound ms" column of rows 2
to 4 of PERF.md's kernel table, so that a change to the program cannot move
the yardstick it is measured by.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, no sparsity),
at the full 700 W power limit.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp8": 1979e12}

# the serving and training LSTM kernels take at most this many batch rows a
# launch (one launch a row slice; ops/lstm_cuda.py's forward plan)
LSTM_ROWS_A_LAUNCH = 256


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least seconds for ``nbytes`` of compulsory traffic and ``flops`` at ``peak``."""
    return max(nbytes / HBM_BYTES_S, flops / peak)


def row_slices(batch: int, rows: int = LSTM_ROWS_A_LAUNCH) -> list[int]:
    """The rows of each launch of a forward LSTM kernel over ``batch`` rows:
    as few launches of at most ``rows`` rows as will do, split evenly."""
    count = -(-batch // rows)
    return [batch // count + (i < batch % count) for i in range(count)]


def lstm_serving_bound_s(batch: int, steps: int, hidden: int, dirs: int = 2,
                         dtype_bytes: int = 4, peak: float = PEAK_FLOPS["fp32"]) -> float:
    """Row 2 (``lstm_recurrence``), one launch: xw ``[D, B, T, 4H]`` and U
    ``[D, H, 4H]`` in, h ``[B, T, D·H]`` out; ``2·D·B·T·H·4H`` operations
    (``chip_smoke.py`` phase 5)."""
    h4 = 4 * hidden
    nbytes = dtype_bytes * (dirs * batch * steps * h4 + dirs * hidden * h4
                            + batch * steps * dirs * hidden)
    return bound_s(nbytes, 2 * dirs * batch * steps * hidden * h4, peak)


def lstm_train_bound_s(which: str, batch: int, steps: int, hidden: int, dirs: int = 2,
                       peak: float = PEAK_FLOPS["fp32"]) -> float:
    """Rows 3 (``which="forward"``) and 4 (``"backward"``), one launch, fp32
    (``chip_smoke.py`` phase 8): the forward reads xw and U and writes h,
    the gates and c; the backward reads the gates, c, dy and U and writes
    dgates. Both need ``2·D·B·T·H·4H`` operations."""
    h4 = 4 * hidden
    gates = 4 * dirs * batch * steps * h4
    cells = 4 * dirs * batch * steps * hidden
    u = 4 * dirs * hidden * h4
    if which not in ("forward", "backward"):
        raise ValueError(f"which is forward or backward, not {which!r}")
    nbytes = gates + u + cells + gates + cells  # the same sum for both
    return bound_s(nbytes, 2 * dirs * batch * steps * hidden * h4, peak)
