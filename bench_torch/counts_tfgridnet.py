"""The yardstick of the ``tfgridnet`` cells, counted from a batch's work and
not from how the program splits it into launches.

A batch of B items padded to ``samples`` samples has T STFT frames
(``reference/tfgridnet.py::frames``) of F = n_fft/2 + 1 bins. Each of the
configuration's blocks runs:

- two serving BiLSTMs (kernel table row 2, H = ``hidden``, bf16): over the
  F − I + 1 windows of the B·T frames (intra) and over the T − I + 1 windows
  of the B·F bins (inter), each bounded by ``counts.lstm_serving_bound_s``
  over all its rows at once, in bf16 at the configuration's peak;
- one attention-scores call (``csrc/wide_attention.cu``) over N = B·heads
  items of L = T frames at d = E·F: it reads Q and K and writes P [N, L, L]
  once in bf16, 2·N·L·d·2 + N·L²·2 bytes, and needs 2·N·L²·d operations,
  at the bf16 peak.
"""

from __future__ import annotations

from bench_torch.counts import PEAK_FLOPS, bound_s, lstm_serving_bound_s


BF16_BYTES = 2


def is_scores(event) -> bool:
    """The attention-scores kernel's launches."""
    return "wide_attention_scores_kernel" in event.name


def grid(cfg: dict, samples: int) -> tuple[int, int]:
    """``(T, F)``: STFT frames and bins of an item padded to ``samples``."""
    n, hop = cfg["n_fft"], cfg["hop"]
    return -(-(samples + n - hop) // hop), n // 2 + 1


def scores_call_bound_s(items: int, length: int, depth: int) -> float:
    """The least seconds of one scores call over ``items`` × ``length`` rows of ``depth``."""
    nbytes = BF16_BYTES * (2 * items * length * depth + items * length * length)
    return bound_s(nbytes, 2 * items * length * length * depth, PEAK_FLOPS["bf16"])


def scores_bound_s(cfg: dict, rows: int, samples: int) -> float:
    """The least seconds of a batch's attention scores: one call a block."""
    t, f = grid(cfg, samples)
    depth = -(-cfg["qk_dim"] // f) * f
    return cfg["blocks"] * scores_call_bound_s(rows * cfg["heads"], t, depth)


def recurrence_rows(cfg: dict, rows: int, samples: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """``((rows, steps) of the intra BiLSTM, (rows, steps) of the inter one)``."""
    t, f = grid(cfg, samples)
    k = cfg["kernel"]
    return (rows * t, f - k + 1), (rows * f, t - k + 1)


def recurrence_bound_s(cfg: dict, rows: int, samples: int) -> float:
    """The least seconds of a batch's serving recurrences: every block's
    intra and inter BiLSTM, each over all its rows, bf16 at the peak."""
    halves = recurrence_rows(cfg, rows, samples)
    return cfg["blocks"] * sum(
        lstm_serving_bound_s(r, s, cfg["hidden"], dtype_bytes=BF16_BYTES, peak=PEAK_FLOPS["bf16"])
        for r, s in halves)
