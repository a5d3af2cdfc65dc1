#!/usr/bin/env python3
"""Where the Conv-TasNet trunk kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_probe_tcn.py [--batch 64] [--frames 4000]
    python3 scripts/torch_probe_tcn.py --backward [--batch 16] [--frames 4000]

Builds copies of ``csrc/tcn_trunk.cu`` with its probe switch ``SST_TRUNK_SKIP``
set by ``-D`` flags, each leaving one part of the work out, and times each
beside the kernel itself at full width (cb 128, ch 256, 21 blocks, dilations
1 to 64; random weights and input from seed 0):

- ``kernel``: the kernel as the port builds it;
- ``no t1 stores``, ``no t2 stores``, ``no h and skip stores``: (A)'s, (B)'s or
  (C)'s output stores left out (with the code that only they need);
- ``no (B) staging``: (B)'s copies of t1 into shared memory left out, the
  taps run on what shared memory holds;
- ``no products``: the wgmma instructions left out; the engine still stages
  its operands.

With ``--backward`` it does the same for the trunk's backward
(``csrc/tcn_train_backward.cu``, switch ``SST_BWD_SKIP``; the products
through ``SST_TRUNK_SKIP``) on the training forward's residuals of a random
input, at the training bench's 16 x 4 s by default:

- ``kernel``: the kernel as the port builds it;
- ``no partial traffic``: the weight gradients' per-CTA partials neither
  loaded nor stored (their products still run);
- ``no weight gradients``: the weight-gradient products and partials left out;
- ``no P5 staging``: P5's copies of dd and t1 into shared memory left out;
- ``no products``: every wgmma instruction left out.

The copies compute wrong outputs by design and are used for nothing else.
Prints one JSON line per copy: milliseconds a call (CUDA events, the best of
two passes, the copies in one order and then in the other), the
microseconds a 128-row tile and block spends in each part of the kernel
(``ops/tcn_cuda.py::TRUNK_LAPS``, from its ``%globaltimer`` laps), and the
registers, spilled bytes and machine instructions (``cuobjdump -sass``) of the
copy's serving kernel, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "speech_separation_tpu_torch" / "csrc"
COPIES = {
    "kernel": 0,
    "no t1 stores": 1,
    "no t2 stores": 2,
    "no h and skip stores": 4,
    "no (B) staging": 8,
    "no products": 16,
}
SERVING = "trunk_kernelILb0ELi3E"  # the serving instance at three taps
# the backward's copies: (SST_BWD_SKIP, SST_TRUNK_SKIP)
BACKWARD_COPIES = {
    "kernel": (0, 0),
    "no partial traffic": (1, 0),
    "no weight gradients": (2, 0),
    "no P5 staging": (4, 0),
    "no products": (0, 16),
}
BACKWARD = "backward_kernelILi3ELb0E"  # the backward's untimed instance at three taps


def ptxas_report(log: str, kernel: str = SERVING) -> dict:
    """Registers and spilled bytes of ``kernel`` in a ``-Xptxas -v`` log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found = {}
            for follow in lines[i + 1:i + 4]:
                if m := re.search(r"(\d+) bytes spill stores", follow):
                    found["spill_store_bytes"] = int(m.group(1))
                if m := re.search(r"Used (\d+) registers", follow):
                    found["registers"] = int(m.group(1))
            return found
    return {}


def sass_instructions(cuobjdump: str, lib: pathlib.Path, kernel: str = SERVING) -> int:
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and re.match(r"\s+/\*[0-9a-f]+\*/", line):
            count += 1
    return count


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backward", action="store_true",
                        help="probe the trunk's backward instead of the forward")
    parser.add_argument("--batch", type=int, default=None, help="64; 16 with --backward")
    parser.add_argument("--frames", type=int, default=4000)
    args = parser.parse_args()
    if args.backward:
        return probe_backward(args.batch or 16, args.frames)
    args.batch = args.batch or 64

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.ops.tcn_cuda import (
        TRUNK_LAPS,
        TRUNK_TILE_ROWS,
        tcn_trunk_cuda,
        trunk_phase_ms,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    b, k, cb, ch = args.batch, args.frames, 128, 256
    dils = tuple(2**x for _ in range(3) for x in range(7))
    n = len(dils)
    gen = torch.Generator(device=device).manual_seed(0)
    vecs = 0.1 * torch.randn(n, 8, 2 * cb, generator=gen, device=device)
    vecs[:, 1] += 1.0
    vecs[:, 6], vecs[:, 7] = 0.25, 0.2
    inputs = (
        torch.randn(b, k, cb, generator=gen, device=device).to(torch.bfloat16),
        (torch.randn(n, cb, ch, generator=gen, device=device) / cb**0.5).to(torch.bfloat16),
        torch.randn(n, 3, ch, generator=gen, device=device) / 3**0.5,
        (torch.randn(n, ch, 2 * cb, generator=gen, device=device) / ch**0.5).to(torch.bfloat16),
        vecs,
    )

    with tempfile.TemporaryDirectory(prefix="probe_tcn_") as tmp:
        paths, procs = {}, {}
        for i, (name, mask) in enumerate(COPIES.items()):
            paths[name] = pathlib.Path(tmp) / f"copy{i}.so"
            # stft_analysis.cu carries sst_error_string, which _build.check calls
            procs[name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, f"-DSST_TRUNK_SKIP={mask}", "-Xptxas", "-v",
                 "-shared", "-o", str(paths[name]), str(CSRC / "tcn_trunk.cu"),
                 str(CSRC / "stft_analysis.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        reports = {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on the probe copy {name!r}:\n{log}")
            reports[name] = {**ptxas_report(log),
                             "sass_instructions": sass_instructions(cuobjdump, paths[name])}
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for entry in ("sst_tcn_trunk", "sst_tcn_trunk_train"):
                getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
            lib.sst_error_string.argtypes = (ctypes.c_int,)
            lib.sst_error_string.restype = ctypes.c_char_p
            libs[name] = lib

        @contextlib.contextmanager
        def built(name):
            """The wrappers launch the copy: the package's loaded library is swapped."""
            saved, _build._library = _build._library, libs[name]
            try:
                yield
            finally:
                _build._library = saved

        def call():
            tcn_trunk_cuda(*inputs, dils=dils)

        ms, laps = {}, {}
        for order in (list(COPIES), list(reversed(COPIES))):
            for name in order:
                with built(name):
                    for _ in range(2):
                        call()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        call()
                    end.record()
                    torch.cuda.synchronize()
                    ms.setdefault(name, []).append(start.elapsed_time(end) / 3)
                    laps[name] = trunk_phase_ms(*inputs, dils=dils)
        for name in COPIES:
            lap = laps[name]
            items = -(-b // lap["groups"])  # items a group walks
            item_tiles = -(-k // TRUNK_TILE_ROWS)
            tiles = -(-item_tiles // lap["ctas"])  # tiles a CTA
            per = {part: round(1e3 * lap[part] / (items * n * tiles), 3) for part in TRUNK_LAPS}
            print(json.dumps({
                "copy": name, "skip_mask": COPIES[name], "batch": b, "frames": k,
                "device": torch.cuda.get_device_name(0), "smi": smi,
                "ms": min(ms[name]), "runs_ms": ms[name], "groups": lap["groups"],
                "ctas": lap["ctas"], "us_per_tile_block": per, **reports[name],
            }), flush=True)
    return 0


def probe_backward(b: int, k: int) -> int:
    """The backward's copies (BACKWARD_COPIES) timed at (b, k), full width."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.ops.tcn_cuda import TRUNK_TILE_ROWS, fold_canonical
    from speech_separation_tpu_torch.ops.tcn_train_cuda import (
        TRUNK_BWD_LAPS,
        tcn_train_backward,
        tcn_train_forward,
        trunk_backward_phase_ms,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    cb, ch = 128, 256
    dils = tuple(2**x for _ in range(3) for x in range(7))
    n = len(dils)
    gen = torch.Generator(device=device).manual_seed(0)
    vecs = 0.1 * torch.randn(n, 10, 2 * cb, generator=gen, device=device)
    vecs[:, 1] += 1.0
    vecs[:, 4] += 1.0
    vecs[:, 7] = 0.0
    vecs[:, 8], vecs[:, 9] = 0.25, 0.2
    canon = (torch.randn(n, cb, ch, generator=gen, device=device) / cb**0.5,
             torch.randn(n, 3, ch, generator=gen, device=device) / 3**0.5,
             torch.randn(n, ch, 2 * cb, generator=gen, device=device) / ch**0.5, vecs)
    h0 = torch.randn(b, k, cb, generator=gen, device=device)
    dskip = torch.randn(b, k, cb, generator=gen, device=device)
    _, hb, st = tcn_train_forward(h0, *fold_canonical(*canon), dils=dils)
    args = (dskip, hb, st, *canon)

    with tempfile.TemporaryDirectory(prefix="probe_tcn_bwd_") as tmp:
        paths, procs = {}, {}
        for i, (name, (bwd, fwd)) in enumerate(BACKWARD_COPIES.items()):
            paths[name] = pathlib.Path(tmp) / f"copy{i}.so"
            procs[name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, f"-DSST_BWD_SKIP={bwd}", f"-DSST_TRUNK_SKIP={fwd}",
                 "-Xptxas", "-v", "-shared", "-o", str(paths[name]),
                 str(CSRC / "tcn_train_backward.cu"), str(CSRC / "stft_analysis.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        reports = {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on the probe copy {name!r}:\n{log}")
            reports[name] = {**ptxas_report(log, BACKWARD),
                             "sass_instructions": sass_instructions(cuobjdump, paths[name],
                                                                    BACKWARD)}
        libs = {}
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            lib.sst_tcn_trunk_backward.argtypes = _build._SIGNATURES["sst_tcn_trunk_backward"]
            lib.sst_tcn_trunk_backward.restype = ctypes.c_int
            lib.sst_error_string.argtypes = (ctypes.c_int,)
            lib.sst_error_string.restype = ctypes.c_char_p
            libs[name] = lib

        @contextlib.contextmanager
        def built(name):
            saved, _build._library = _build._library, libs[name]
            try:
                yield
            finally:
                _build._library = saved

        ms, laps = {}, {}
        for order in (list(BACKWARD_COPIES), list(reversed(BACKWARD_COPIES))):
            for name in order:
                with built(name):
                    tcn_train_backward(*args, dils=dils)
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(3):
                        tcn_train_backward(*args, dils=dils)
                    end.record()
                    torch.cuda.synchronize()
                    ms.setdefault(name, []).append(start.elapsed_time(end) / 3)
                    laps[name] = trunk_backward_phase_ms(*args, dils=dils)
        for name in BACKWARD_COPIES:
            lap = laps[name]
            items = -(-b // lap["groups"])
            tiles = -(-(-(-k // TRUNK_TILE_ROWS)) // lap["ctas"])
            per = {part: round(1e3 * lap[part] / (items * n * tiles), 3) for part in TRUNK_BWD_LAPS}
            print(json.dumps({
                "copy": name, "skip_mask": BACKWARD_COPIES[name], "batch": b, "frames": k,
                "device": torch.cuda.get_device_name(0), "smi": smi,
                "ms": min(ms[name]), "runs_ms": ms[name], "groups": lap["groups"],
                "ctas": lap["ctas"], "ms_a_cta": {p_: round(lap[p_], 3) for p_ in TRUNK_BWD_LAPS},
                "us_per_tile_block": per, **reports[name],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
