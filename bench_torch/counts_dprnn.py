"""The yardstick of the ``dprnn`` cells' serving recurrences (kernel table
row 2 at the dual-path shapes), counted from a batch's work and not from how
the program slices it into launches.

A batch of B items padded to T encoder frames has S = ceil(T / P) + 1
chunks of K = 2P frames. Each of the configuration's blocks runs two
BiLSTMs: over the K frames of the B·S chunks (intra) and over the S chunks
at the B·K chunk positions (inter). Their bound is
``counts.lstm_serving_bound_s`` over all of a BiLSTM's rows at once, so a
program that launches the same work in other slices is read against the
same bound.
"""

from __future__ import annotations

from bench_torch.counts import lstm_serving_bound_s
from bench_torch.readers import instance_of

# the serving forward (template argument 1, the training mode, false)
SERVING_LSTM = instance_of("lstm_fwd_persistent_kernel", lambda a: a[1] == "false")


def dual_path_rows(cfg: dict, rows: int, samples: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """``((rows, steps) of the intra BiLSTM, (rows, steps) of the inter one)``
    for a batch of ``rows`` items padded to ``samples`` samples."""
    hop = cfg["chunk"] // 2
    frames = samples // (cfg["win"] // 2)
    chunks = -(-frames // hop) + 1
    k = cfg["chunk"]
    return (rows * chunks, k), (rows * k, chunks)


def dual_path_bound_s(cfg: dict, rows: int, samples: int) -> float:
    """The least seconds of a batch's serving recurrences: every block's
    intra and inter BiLSTM, each over all its rows."""
    (intra_rows, intra_steps), (inter_rows, inter_steps) = dual_path_rows(cfg, rows, samples)
    per_block = (lstm_serving_bound_s(intra_rows, intra_steps, cfg["hidden"])
                 + lstm_serving_bound_s(inter_rows, inter_steps, cfg["hidden"]))
    return cfg["blocks"] * per_block
