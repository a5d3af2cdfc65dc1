#!/usr/bin/env python3
"""Where the persistent LSTM backward kernel's step time goes, on one NVIDIA GPU.

    python3 scripts/torch_probe_lstm_backward.py [--batch 32] [--steps 501] [--hidden 496]
                                                 [--sass DIR]

Builds copies of ``csrc/lstm_train_backward.cu`` with the kernel's probe
switches set by ``-D`` flags, and times each beside the kernel itself at the
bench's shape (B = 32, T = 501, H = 496, both directions) in fp32 and bf16:

- ``kernel``: the kernel as the port builds it;
- ``no product``: the dgates_{s+1} chunks are still loaded, not multiplied;
- ``no loads``: the chunks are not loaded, the product runs on what shared
  memory holds;
- ``barrier and gates only``: neither; what is left is the per-step barrier,
  the gate backward and the stores;
- ``fp32 two blocks an SM``: fp32's launch bounds at two blocks an SM, which
  hold it to 128 registers a thread;
- ``tile loop not unrolled``: the fp32 tile's column loop not unrolled;
- ``bf16 256-column chunks, two blocks an SM``: bf16 staged 256 columns at a
  time (a round trip to L2 for each eighth of a step's dgates at H = 496),
  with launch bounds at two blocks an SM (128 registers a thread);
- ``bf16 256-column chunks``, ``bf16 512-column chunks``, ``bf16
  2048-column chunks``: bf16's chunk width alone changed.

The first three copies compute wrong dgates by design; the others must equal
the kernel's, which the line reports. They are used for nothing else. Prints
one JSON line per compute type: milliseconds a call and microseconds a step
of each variant (the best of two passes, the variants in one order and then
in the other), and the registers a thread that ptxas gave each copy's kernels,
with the card's name and power limit. ``--sass DIR`` also writes each copy's
machine code (``cuobjdump -sass``) to ``DIR/<variant>.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "speech_separation_tpu_torch" / "csrc" / "lstm_train_backward.cu"

VARIANTS = {
    "kernel": [],
    "no product": ["-DSST_BWD_SKIP_PRODUCT=1"],
    "no loads": ["-DSST_BWD_SKIP_LOADS=1"],
    "barrier and gates only": ["-DSST_BWD_SKIP_PRODUCT=1", "-DSST_BWD_SKIP_LOADS=1"],
    "fp32 two blocks an SM": ["-DSST_BWD_FP32_BLOCKS_PER_SM=2"],
    "tile loop not unrolled": ["-DSST_BWD_TILE_UNROLL=1"],
    "bf16 256-column chunks, two blocks an SM": ["-DSST_BWD_BF16_CHUNK=256",
                                                 "-DSST_BWD_BF16_BLOCKS_PER_SM=2"],
    "bf16 256-column chunks": ["-DSST_BWD_BF16_CHUNK=256"],
    "bf16 512-column chunks": ["-DSST_BWD_BF16_CHUNK=512"],
    "bf16 2048-column chunks": ["-DSST_BWD_BF16_CHUNK=2048"],
}
EXACT = tuple(VARIANTS)[4:]  # built otherwise, computing the same dgates


def registers(ptxas_log: str) -> dict:
    """Registers a thread of each backward kernel instance in a ``-Xptxas -v``
    log, keyed by compute type and keep flag (``fp32``, ``bf16+keep``, ...)."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and name and "lstm_bwd_persistent_kernel" in name:
            kind = "fp32" if "kernelIf" in name else "bf16"
            out[kind + ("+keep" if "Lb1E" in name else "")] = int(used.group(1))
            name = None
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--steps", type=int, default=501)
    parser.add_argument("--hidden", type=int, default=496)
    parser.add_argument("--sass", type=pathlib.Path, help="write each copy's SASS here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.ops import lstm_train_cuda as L

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory(prefix="probe_lstm_bwd_") as tmp:
        libs, procs = {}, {}
        for i, (name, flags) in enumerate(VARIANTS.items()):
            libs[name] = pathlib.Path(tmp) / f"variant{i}.so"  # nvcc splits names at commas
            procs[name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
                 str(libs[name]), str(SOURCE)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        regs = {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on the probe copy {name!r}:\n{log}")
            regs[name] = registers(log)
            if args.sass:
                args.sass.mkdir(parents=True, exist_ok=True)
                cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
                (args.sass / (name.replace(" ", "_").replace(",", "") + ".sass")).write_text(
                    subprocess.run([str(cuobjdump), "-sass", str(libs[name])], capture_output=True,
                                   text=True, check=True).stdout)
        fns = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(str(path)).sst_lstm_train_backward
            fn.argtypes = _build._SIGNATURES["sst_lstm_train_backward"]
            fn.restype = ctypes.c_int
            fns[name] = fn

        b, t, h = args.batch, args.steps, args.hidden
        gen = torch.Generator(device=device).manual_seed(0)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xw = torch.randn(2, b, t, 4 * h, generator=gen, device=device)
            u = (torch.randn(2, h, 4 * h, generator=gen, device=device) / h**0.5).to(dtype)
            _, gates, c_all = L.lstm_train_forward(xw, u, compute_dtype=dtype)
            dy = torch.randn(b, t, 2 * h, generator=gen, device=device).to(dtype)
            out = torch.empty_like(gates)
            plan = L.backward_plan(b, h, dtype == torch.bfloat16, **L._device_limits(device))

            def run(fn):
                counters = torch.zeros((2, plan.row_blocks), dtype=torch.int32, device=device)
                code = fn(gates.data_ptr(), c_all.data_ptr(), dy.data_ptr(), u.data_ptr(), None,
                          out.data_ptr(), counters.data_ptr(), 2, b, t, h, L.REVERSE_MASK,
                          int(dtype == torch.bfloat16), plan.groups, int(plan.resident),
                          torch.cuda.current_stream().cuda_stream)
                if code != 0:
                    raise RuntimeError(f"probe launch failed: CUDA error {code}")

            run(fns["kernel"])
            want = out.clone()
            times, exact = {}, {}
            for order in (list(fns), list(reversed(fns))):
                for name in order:
                    run(fns[name])
                    if name in EXACT:
                        exact[name] = torch.equal(out, want)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(5):
                        run(fns[name])
                    end.record()
                    torch.cuda.synchronize()
                    times.setdefault(name, []).append(start.elapsed_time(end) / 5)
            print(json.dumps({
                "dtype": tag, "batch": b, "steps": t, "hidden": h, "smi": smi,
                "plan": {"groups": plan.groups, "resident": plan.resident, "smem": plan.smem,
                         "blocks": plan.blocks},
                "ms": {k: min(v) for k, v in times.items()},
                "us_per_step": {k: 1e3 * min(v) / t for k, v in times.items()},
                "registers": {k: {kind: n for kind, n in v.items() if kind.startswith(tag)}
                              for k, v in regs.items()},
                "equal_to_kernel": exact,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
