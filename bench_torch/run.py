"""Run one cell of the PyTorch port's benchmark once, on this machine's card.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` beside ``bench_torch/``).
Prints the compared numbers beside their limits as the last lines of
standard error and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last. Exits non-zero, printing
no result, where there is no CUDA device or fewer than the cell needs.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time


def _process_age_s() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        start_ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age_s()
ROOT = pathlib.Path(__file__).resolve().parent.parent
# caches a program may build or compile into stay inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "bench_torch" / ".cache" / sub))


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness

    try:
        cell = harness.Cell.find(args.workload)
        harness.require_devices(cell.chips)
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                                  device=torch.device("cuda", 0))
    except harness.BenchError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    for line in harness.check_lines(result):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
