"""Read the numbers that decide ``correct`` over many seeds in one process,
for setting their limits: the program's (the lower readings), the
control's (the reference in the program's place, in the configuration's
``control_precision``) and a planted fault's (``faults.py``).

    python3 bench_torch/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3 \
        [--mode program|control] [--fault <fault>] [--out <file.jsonl>]

Each run is a whole run of the cell (set-up, a window of ``--seconds`` at
the cell's own load, the comparison), on the card. One JSON line a run, on
standard output and appended to ``--out``; then the largest and smallest
reading of each number.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    import argparse

    sys.path.insert(0, str(ROOT))
    import torch

    from bench_torch import harness
    from bench_torch.faults import FAULTS

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--mode", default="program",
                        help="program, control, or a precision (fp64, fp32, bf16, ...) of the "
                             "reference in the program's place")
    parser.add_argument("--baseline", default="fp32",
                        help="the precision of the reference compared with (fp32, or fp64)")
    parser.add_argument("--fault", default=None, choices=FAULTS)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    cell = harness.Cell.find(args.workload)
    harness.require_devices(cell.chips)
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = harness.run_cell(cell, seed, args.seconds, False, t_start=t0,
                                  device=torch.device("cuda", 0), mode=args.mode, fault=args.fault,
                                  baseline=args.baseline)
        line = {"workload": args.workload, "seed": seed, "mode": args.mode, "fault": args.fault,
                "baseline": args.baseline,
                "checks": {k: c["value"] for k, c in result["checks"].items()},
                "correct": result["correct"], "attempted": result["attempted"],
                "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        readings.append(line)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    for name in readings[0]["checks"]:
        values = [r["checks"][name] for r in readings]
        print(json.dumps({"number": name, "mode": args.mode, "fault": args.fault,
                          "largest": max(values), "smallest": min(values), "runs": len(values)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
