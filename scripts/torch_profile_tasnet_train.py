#!/usr/bin/env python3
"""Where Conv-TasNet's device time goes, on one NVIDIA GPU: the train step, or
with ``--serve`` the serving batch.

    python3 scripts/torch_profile_tasnet_train.py [--batch 16] [--seconds 4] [--steps 2]
    python3 scripts/torch_profile_tasnet_train.py --serve [--batch 64] [--seconds 8] [--steps 2]

Builds the full-width ``ConvTasNet`` of the PyTorch port (2,226,092 random
parameters from seed 0) and profiles, with ``torch.profiler`` after two
warm-up iterations, either ``make_time_domain_steps`` train steps at
``bench.py::bench_tasnet_train``'s shape (16 × 4 s at 8 kHz, win 16) for the
kernel path (``pallas_trunk=True``) and the module's own autograd in bf16, or
(``--serve``) ``cuda_apply`` at ``bench_tasnet``'s shape (64 × 8 s, win 16,
``default_rng(0)`` normal × 0.1), the path ``cli separate --kernel pallas``
runs. Prints one JSON line per path: host wall time per iteration, device
busy time and idle share, the device time of the trunk kernels by launch
name, of cuBLAS, cuDNN and the rest, and peak device memory, with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# device kernels by (demangled) name: the trunk kernels' launches
# (csrc/tcn_trunk.cu, csrc/tcn_train_backward.cu), then cuDNN before cuBLAS
# (cuDNN's convolutions are implicit GEMMs and carry "gemm" in their names)
GROUPS = (
    ("trunk forward (one persistent launch: A, B, C of every block)", ("::trunk_kernel",)),
    ("trunk backward (one persistent launch: P1 to P6 of every block)", ("::backward_kernel",)),
    ("convolutions (cuDNN)", ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "conv")),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "Kernel2")),
)

ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--serve", action="store_true", help="profile cuda_apply (64 x 8 s)")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--seconds", type=float, default=None)
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()
    if args.batch is None:
        args.batch = 64 if args.serve else 16
    if args.seconds is None:
        args.seconds = 8.0 if args.serve else 4.0

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, ".")
    from speech_separation_tpu_torch import train
    from speech_separation_tpu_torch.models.tasnet import ConvTasNet
    from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    samples = int(args.seconds * 8000)
    if args.serve:
        mix = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (args.batch, samples)).astype(np.float32) * 0.1).to(device)
        paths = {"cuda_apply (serving, kernel trunk)": None}
    else:
        src = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (args.batch, 2, samples)).astype(np.float32) * 0.1).to(device)
        batch = (src.sum(1), src, torch.full((args.batch,), samples, dtype=torch.int32,
                                             device=device))
        paths = {"kernel path": dict(compute_dtype=torch.bfloat16, pallas_trunk=True),
                 "module bf16": dict(compute_dtype=torch.bfloat16)}
    for what, kwargs in paths.items():
        model = ConvTasNet(generator=torch.Generator().manual_seed(0)).to(device)
        if args.serve:
            model.eval()
            state = None

            def step():
                with torch.inference_mode():
                    cuda_apply(model, mix)
        else:
            state = train.TrainState.create(model, train.adam(1e-3), seed=0)
            train_step, _ = train.make_time_domain_steps(model, **kwargs)

            def step():
                train_step(state, *batch)
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
        # device kernels and copies; not the GPU spans of user annotations
        # (Optimizer.step#...), which overlap the kernels they enclose
        events = [e for e in prof.events()
                  if e.device_type.name == "CUDA" and not e.name.startswith(ANNOTATIONS)]
        busy_us = sum(e.time_range.elapsed_us() for e in events) / args.steps
        first = min(e.time_range.start for e in events)
        last = max(e.time_range.end for e in events)
        span_us = (last - first) / args.steps
        groups = {name: 0.0 for name, _ in GROUPS}
        groups["the rest (elementwise, reductions, copies, optimizer)"] = 0.0
        launches = 0
        rest: dict[str, list[float]] = {}
        for e in events:
            key = next((name for name, keys in GROUPS if any(k in e.name for k in keys)),
                       "the rest (elementwise, reductions, copies, optimizer)")
            groups[key] += e.time_range.elapsed_us() / args.steps
            launches += 1
            if key.startswith("the rest"):
                entry = rest.setdefault(e.name[:120], [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / args.steps
                entry[1] += 1
        top = sorted(rest.items(), key=lambda kv: -kv[1][0])[:12]
        print(json.dumps({
            "path": what, "batch": args.batch, "seconds": args.seconds, "smi": smi,
            "device": torch.cuda.get_device_name(0),
            "wall_ms_per_step": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "device_span_ms": span_us / 1e3,
            "idle_share": max(0.0, 1.0 - busy_us / (1e6 * wall)),
            "launches_per_step": launches / args.steps,
            "ms_by_group": {k: round(v / 1e3, 3) for k, v in groups.items() if v},
            "rest_top_ms": [[name, round(ms / 1e3, 3), n // args.steps] for name, (ms, n) in top],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }), flush=True)
        del model, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
