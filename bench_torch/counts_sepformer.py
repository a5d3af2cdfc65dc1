"""The yardstick of the ``sepformer`` cells' attention (SDPA's flash kernel
in the dual-path transformer), counted from a batch's work and not from how
the backend splits it into launches.

A batch of B items padded to T encoder frames has S = ceil(T / P) + 1
chunks of K = 2P frames (``counts_dprnn.dual_path_rows``). Each of the
configuration's blocks runs ``layers`` attention calls over the B·S chunks
of K frames (intra) and ``layers`` over the B·K chunk positions of S chunks
(inter). One call over N sequences of L tokens at width d reads Q, K and V
and writes O once in bf16, 4 · N·L · d · 2 bytes, and needs 4 · L · d
operations a token (QKᵀ and PV); its bound is the larger of the bytes over
the HBM bandwidth and the operations over the bf16 peak.
"""

from __future__ import annotations

from bench_torch.counts import PEAK_FLOPS, bound_s
from bench_torch.counts_dprnn import dual_path_rows

BF16_BYTES = 2


def is_attention(event) -> bool:
    """The flash kernel's launches: its forward, and its split-KV forward and
    the combine after it, where the backend splits the keys."""
    return "flash_fwd" in event.name


def attention_call_bound_s(sequences: int, length: int, d_model: int) -> float:
    """The least seconds of one attention call over ``sequences`` × ``length`` tokens."""
    tokens = sequences * length
    return bound_s(4 * tokens * d_model * BF16_BYTES, 4 * length * d_model * tokens,
                   PEAK_FLOPS["bf16"])


def attention_bound_s(cfg: dict, rows: int, samples: int) -> float:
    """The least seconds of a batch's attention: every layer of both halves
    of every block, each call over all its sequences."""
    (intra_rows, k), (inter_rows, s) = dual_path_rows(cfg, rows, samples)
    per_layer = (attention_call_bound_s(intra_rows, k, cfg["d_model"])
                 + attention_call_bound_s(inter_rows, s, cfg["d_model"]))
    return cfg["blocks"] * cfg["layers"] * per_layer
