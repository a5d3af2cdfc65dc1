"""The cost of the port's profiler spans (``utils/profiling.py::span``) on a
CUDA card: µs a span on the host's clock with the profiler off, as a host
span and as a device span with the profiler recording, each around an empty
block and around one small kernel launch; the garbage collector's ms by
generation over the device spans; and the µs a pair costs to read back
through ``device_ms``.

    python3 scripts/torch_probe_spans.py [--spans 10000]

from the root of a checkout. Prints one JSON line, the card's name and power
limit in it.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(0)


def _loop_us(spans: int, device: bool, x: torch.Tensor | None) -> float:
    from speech_separation_tpu_torch.utils.profiling import span

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(spans):
        with span("probe", device=device):
            if x is not None:
                x.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / spans


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--spans", type=int, default=10_000)
    args = parser.parse_args(argv)
    sys.path.insert(0, ".")
    from speech_separation_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    x = torch.zeros(1024, device="cuda")
    result = {"card": _card(), "torch": torch.__version__, "spans": args.spans}
    for block, arg in (("empty", None), ("one_launch", x)):
        _loop_us(1000, True, arg)  # warm-up, profiler off
        result[f"off_us.{block}"] = _loop_us(args.spans, True, arg)
        for kind, device in (("host", False), ("device", True)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                _loop_us(100, device, arg)  # the profiler's own start-up out of the loop
                profiling.clear_device_spans()
                gc_ms = [0.0, 0.0, 0.0]
                t_start = [0.0]

                def clock(phase, info):
                    if phase == "start":
                        t_start[0] = time.perf_counter()
                    else:
                        gc_ms[info["generation"]] += 1e3 * (time.perf_counter() - t_start[0])

                gc.callbacks.append(clock)
                try:
                    result[f"on_us.{kind}.{block}"] = _loop_us(args.spans, device, arg)
                finally:
                    gc.callbacks.remove(clock)
            if device:
                result[f"gc_ms.{block}"] = [round(t, 3) for t in gc_ms]
                t0 = time.perf_counter()
                times = profiling.device_ms("sst.probe")
                result[f"read_us_a_pair.{block}"] = 1e6 * (time.perf_counter() - t0) / len(times)
                result[f"device_us_a_span.{block}"] = 1e3 * sum(times) / len(times)
                profiling.clear_device_spans()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
