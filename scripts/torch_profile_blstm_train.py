#!/usr/bin/env python3
"""Where the BLSTM training step's device time goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_blstm_train.py [--batch 32] [--seconds 8] [--steps 2]

Builds the full-width ``UPitBlstm`` of the PyTorch port (16,077,602 random
parameters from seed 0) and profiles ``make_upit_waveform_steps`` train steps
(``exponential_decay_adam``, dropout 0.8) at ``bench.py::bench_blstm_train``'s
shape (32 × 8 s at 8 kHz, T = 501 frames) with ``torch.profiler``, after two
warm-up steps, in fp32 and in bf16. Prints one JSON line per compute type:
host wall time per step, device busy time and idle share, launches per step,
the device time of the port's kernels by launch name (the STFT, the LSTM
persistent forward and backward), of cuBLAS and of the rest, and
peak device memory, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# device kernels by (demangled) name: the port's kernels (csrc/stft_analysis.cu,
# csrc/lstm_recurrence.cu, csrc/lstm_train_backward.cu), then cuBLAS
GROUPS = (
    ("stft_analysis", ("stft_fft_kernel",)),
    ("lstm_train_forward", ("lstm_fwd_persistent_kernel",)),
    ("lstm_train_backward", ("lstm_bwd_persistent_kernel",)),
    ("GEMMs (cuBLAS)", ("gemm", "xmma", "cutlass", "Kernel2")),
)
REST = "the rest (elementwise, reductions, copies, optimizer)"
ANNOTATIONS = ("Optimizer.", "ProfilerStep")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--steps", type=int, default=2)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, ".")
    from speech_separation_tpu_torch import train
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.ops.stft import stft_frame_count

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    samples = int(args.seconds * 8000)
    frames = stft_frame_count(samples, 256, 128)
    gen = torch.Generator(device=device).manual_seed(0)
    sources = 0.1 * torch.randn(args.batch, 2, samples, generator=gen, device=device)
    batch = (sources.sum(1), sources,
             torch.full((args.batch,), frames, dtype=torch.int32, device=device))
    for tag, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device)
        state = train.TrainState.create(model, train.exponential_decay_adam(), seed=0)
        step, _ = train.make_upit_waveform_steps(model, compute_dtype=dtype)
        for _ in range(2):
            step(state, *batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step(state, *batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps
        # device kernels and copies; not the GPU spans of user annotations
        # (Optimizer.step#...), which overlap the kernels they enclose
        events = [e for e in prof.events()
                  if e.device_type.name == "CUDA" and not e.name.startswith(ANNOTATIONS)]
        busy_us = sum(e.time_range.elapsed_us() for e in events) / args.steps
        groups = {name: [0.0, 0] for name, _ in GROUPS}
        groups[REST] = [0.0, 0]
        rest: dict[str, list[float]] = {}
        for e in events:
            key = next((name for name, keys in GROUPS if any(k in e.name for k in keys)), REST)
            groups[key][0] += e.time_range.elapsed_us() / args.steps
            groups[key][1] += 1
            if key == REST:
                entry = rest.setdefault(e.name[:120], [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / args.steps
                entry[1] += 1
        top = sorted(rest.items(), key=lambda kv: -kv[1][0])[:10]
        print(json.dumps({
            "path": f"BLSTM train step {tag}, kernel path", "batch": args.batch,
            "seconds": args.seconds, "frames": frames, "smi": smi,
            "wall_ms_per_step": 1e3 * wall,
            "audio_s_per_s": args.batch * args.seconds / wall,
            "device_busy_ms": busy_us / 1e3,
            "idle_share": max(0.0, 1.0 - busy_us / (1e6 * wall)),
            "launches_per_step": len(events) / args.steps,
            "ms_by_group": {k: round(v / 1e3, 3) for k, (v, _) in groups.items() if v},
            "launches_by_group": {k: n // args.steps for k, (_, n) in groups.items() if n},
            "rest_top_ms": [[name, round(ms / 1e3, 3), n // args.steps] for name, (ms, n) in top],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        }), flush=True)
        del model, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
