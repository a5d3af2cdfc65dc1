#!/usr/bin/env python3
"""Where TF-GridNet's serving device time goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_tfgridnet.py [--batch 16] [--seconds 10] [--calls 3]

Builds the PyTorch port's TF-GridNet at its published widths (15,152,696
parameters, ``bench_torch/reference/tfgridnet.py::make_weights`` from seed 0)
and serves a batch of ``--batch`` mixtures of ``--seconds`` through
``models.tfgridnet.serving_fn(bf16=True)``, the path of ``cli separate
--bf16`` and of the ``tfgridnet_separate`` cell. After two warm-up calls it
times ``--calls`` calls (host clock around each, ending in a synchronise;
CUDA events around all) and profiles one more with ``torch.profiler``.
Prints one JSON line: the median ms a call and audio-s/s, the device time a
call and its split by kind of kernel (the serving LSTM recurrence, the
attention scores kernel, cuBLAS GEMMs, the fused residual add and
LayerNorm, cuDNN's convolutions, the STFT, elementwise passes, casts and
copies, reductions, the rest), launches by kind, each kind's three largest
kernels by name and the rest's ten, the host ms in the port's spans, peak
device memory, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

# device kernels by (demangled) name, first match wins
GROUPS = (
    ("LSTM recurrence", ("lstm_fwd_persistent",)),
    ("attention scores", ("wide_attention_scores",)),
    ("fused add and LayerNorm", ("residual_layer_norm",)),
    ("STFT", ("stft_",)),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
    ("convolutions (cuDNN)", ("cudnn", "implicit_convolve", "dgrad", "wgrad", "fprop")),
    ("casts and copies", ("copy_kernel", "Memcpy", "Memset")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "CUDAFunctor", "where", "Functor")),
)
REST = "the rest"
SPANS = ("encode", "intra", "inter", "attention", "decode")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--calls", type=int, default=3)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from bench_torch.reference import tfgridnet as reference
    from speech_separation_tpu_torch.models.tfgridnet import TFGridNet, serving_fn

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = json.loads((root / "bench_torch" / "configs" / "tfgridnet.json").read_text())
    weights = reference.make_weights(cfg, 0, device)
    with torch.device("meta"):
        model = TFGridNet()
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    serve = serving_fn(model, bf16=True)
    gen = torch.Generator(device=device).manual_seed(0)
    mix = 0.1 * torch.randn(args.batch, int(args.seconds * 8000), generator=gen, device=device)
    for _ in range(2):
        serve(mix)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.calls):
        t0 = time.perf_counter()
        serve(mix)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve(mix)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    groups = {name: [0.0, 0] for name, _ in GROUPS}
    groups[REST] = [0.0, 0]
    names: dict[str, dict[str, list[float]]] = {}  # group -> kernel name -> [us, launches]
    for e in events:
        key = next((name for name, keys in GROUPS if any(k in e.name for k in keys)), REST)
        groups[key][0] += e.time_range.elapsed_us()
        groups[key][1] += 1
        entry = names.setdefault(key, {}).setdefault(e.name[:120], [0.0, 0])
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1

    def largest(group: str, n: int):
        ranked = sorted(names.get(group, {}).items(), key=lambda kv: -kv[1][0])[:n]
        return [[name, round(us / 1e3, 3), count] for name, (us, count) in ranked]

    spans = {name: round(sum(e.time_range.elapsed_us() for e in prof.events()
                             if e.name == f"sst.tfgridnet.{name}") / 1e3, 3) for name in SPANS}
    median = statistics.median(walls)
    print(json.dumps({
        "path": "TF-GridNet serving_fn bf16", "batch": args.batch, "seconds": args.seconds,
        "smi": smi, "wall_ms": walls, "median_ms": median,
        "event_ms_per_call": start.elapsed_time(end) / args.calls,
        "audio_s_per_s": args.batch * args.seconds / (median / 1e3),
        "device_ms": busy_us / 1e3, "launches": len(events),
        "ms_by_group": {k: round(v / 1e3, 3) for k, (v, _) in groups.items() if v},
        "share_by_group": {k: round(100 * v / busy_us, 1) for k, (v, _) in groups.items() if v},
        "launches_by_group": {k: n for k, (_, n) in groups.items() if n},
        "top_ms_by_group": {k: largest(k, 3) for k in groups if k != REST and groups[k][1]},
        "rest_top_ms": largest(REST, 10),
        "host_ms_in_spans": spans,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
