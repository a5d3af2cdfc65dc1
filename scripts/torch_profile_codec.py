#!/usr/bin/env python3
"""Where the t3tok codec's device time goes, serving and training, on one NVIDIA GPU.

    python3 scripts/torch_profile_codec.py [--batch 64] [--train-batch 8] [--seconds 8] [--iters 3]

Loads the committed trained t3tok (``artifacts/t3tok_hard/params_ep38.npz``,
307,880 parameters) into the PyTorch port and profiles with
``torch.profiler``, after two warm-up calls: ``codes`` (tokenizer serving),
``decode_codes`` and the deterministic forward at 64 × 8 s, and the
``make_vae_steps`` train step (NAdam 1e-3) at 8 × 8 s, the committed run's
batch size. Inputs are ``default_rng(0)`` normal × 0.1, frame-stacked
``[B, 1600, 40]``. Prints one JSON line per path: host wall time per call,
device busy time and idle share, launches per call, the device time of the
``nearest_code`` kernel, of cuDNN, cuBLAS and the rest (with the rest's
largest kernels by name), and peak device memory, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
# device kernels by (demangled) name; cuDNN before cuBLAS (cuDNN's
# convolutions are implicit GEMMs and carry "gemm" in their names)
GROUPS = (
    ("nearest_code (csrc/nearest_code.cu)", ("nearest_code_kernel",)),
    ("convolutions (cuDNN)", ("cudnn", "fprop", "dgrad", "wgrad", "implicit", "conv")),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "Kernel2")),
)
REST = "the rest (lookups, elementwise, reductions, copies, optimizer)"
ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--train-batch", type=int, default=8)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--iters", type=int, default=3)
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import cli, train
    from speech_separation_tpu_torch.losses import summed_squared_error
    from speech_separation_tpu_torch.utils import VaeTrainConfig, load_config
    from speech_separation_tpu_torch.weights import load_params_npz

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    codec = ROOT / "artifacts" / "t3tok_hard"
    cfg = load_config(VaeTrainConfig, codec / "train_config.json")
    model = cli._build_vae_model(cfg, device)
    model.load_state_dict(load_params_npz(codec / "params_ep38.npz"))
    model.eval()
    frames = int(args.seconds * cfg.sample_rate) // 40
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, frames, 40)).astype(np.float32) * 0.1).to(device)
    with torch.inference_mode():
        codes = model.codes(audio)

    net = cli._build_vae_model(cfg, device)
    net.load_state_dict(model.state_dict())
    state = train.TrainState.create(net, train.nadam(1e-3), seed=0)
    step, _ = train.make_vae_steps(
        net, lambda p, t: summed_squared_error(p.reshape(p.shape[0], -1, 1), t))
    inputs = audio[: args.train_batch]
    targets = inputs.reshape(args.train_batch, -1, 1)

    paths = {
        "codes": (args.batch, lambda: model.codes(audio)),
        "decode_codes": (args.batch, lambda: model.decode_codes(*codes)),
        "forward": (args.batch, lambda: model(audio, deterministic=True)),
        "train step": (args.train_batch, lambda: step(state, inputs, targets)),
    }
    for what, (batch, fn) in paths.items():
        grad = what == "train step"
        with torch.inference_mode(not grad):
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / args.iters
        # device kernels and copies; not the GPU spans of user annotations
        events = [e for e in prof.events()
                  if e.device_type.name == "CUDA" and not e.name.startswith(ANNOTATIONS)]
        busy_us = sum(e.time_range.elapsed_us() for e in events) / args.iters
        groups = {name: 0.0 for name, _ in GROUPS}
        groups[REST] = 0.0
        counts = {name: 0 for name in groups}
        rest: dict[str, list[float]] = {}
        for e in events:
            key = next((name for name, keys in GROUPS if any(k in e.name for k in keys)), REST)
            groups[key] += e.time_range.elapsed_us() / args.iters
            counts[key] += 1
            if key == REST:
                entry = rest.setdefault(e.name[:100], [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / args.iters
                entry[1] += 1
        top = sorted(rest.items(), key=lambda kv: -kv[1][0])[:8]
        print(json.dumps({
            "path": what, "batch": batch, "seconds": args.seconds, "smi": smi,
            "wall_ms": 1e3 * wall, "device_busy_ms": busy_us / 1e3,
            "idle_share": max(0.0, 1.0 - busy_us / (1e6 * wall)),
            "launches": len(events) / args.iters,
            "ms_by_group": {k: round(v / 1e3, 4) for k, v in groups.items() if v},
            "launches_by_group": {k: v // args.iters for k, v in counts.items() if v},
            "rest_top_ms": [[name, round(ms / 1e3, 4), n // args.iters] for name, (ms, n) in top],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
