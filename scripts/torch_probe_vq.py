#!/usr/bin/env python3
"""Where the nearest-code search kernel's time goes, on one NVIDIA GPU.

    python3 scripts/torch_probe_vq.py [--first-port PATH] [--beside PATH] [--scale]

Builds copies of ``csrc/nearest_code.cu`` with its probe switches set by
``-D`` flags and times each beside the kernel itself at the t3tok codec's
shapes at 64 x 8 s (random fp32 inputs from seed 0): the deep search (N =
12,800, D = 64, K = 512), the skip search with one group (N = 51,200, D = 16)
and one skip stage as one grouped call (N = 51,200, 4 groups of S = 16, the
groups read in place from a [N, 64] residual):

- ``kernel``: the kernel as the port builds it;
- ``no row staging``, ``no codebook staging``: ``SST_VQ_SKIP`` 1 or 2, the
  rows' or the codebook's cp.async copies left out;
- ``no compare``: ``SST_VQ_SKIP=4``, each score summed instead of compared;
- ``no products``: ``SST_VQ_SKIP=16``, the products left out (the rest of
  the kernel as it is).

The copies that leave work out compute wrong picks by design and are used
for nothing else; the kernel's picks are held against the plain version (a differing pick must be a near tie). ``--first-port``
names a source of the first port of this kernel (one launch of 64-row
blocks a 2-D call, entry ``sst_nearest_code(flat, codebook, out, rows, dim,
codes, stream)``), timed beside the copies with a skip stage as its four
launches on contiguous slices (the slices' copies not counted).
``--beside`` names another revision of this kernel's source with the same
entry (an earlier commit's ``csrc/nearest_code.cu``), built, checked and
timed beside the kernel as ``beside``.

``--scale`` also times the port's kernel at the deep search's widths (D =
64, K = 512) with 1 to 28 units a CTA, and fits the time as a part that does
not grow with the units plus a cost a unit.

Times are device milliseconds a call (CUDA events, 50 calls queued behind a
sleep kernel, the best of two passes in opposite orders). Prints one JSON
line per copy with its times by shape, its registers and spilled bytes
from ``-Xptxas -v``, and the card's name and power limit.
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
# name: the copy's -D switches (SST_VQ_<key>=<value>)
COPIES = {
    "kernel": {},
    "no row staging": {"SKIP": 1},
    "no codebook staging": {"SKIP": 2},
    "no compare": {"SKIP": 4},
    "no products": {"SKIP": 16},
}


def defines(switches: dict) -> tuple[str, ...]:
    return tuple(f"-DSST_VQ_{key}={value}" for key, value in switches.items())


SHAPES = {"deep": (12_800, 1, 64, 512), "skip": (51_200, 1, 16, 512),
          "skip stage": (51_200, 4, 16, 512)}
NEAR_TIE_REL = 1e-5  # chip_smoke.py's bound on a differing pick


def ptxas_report(log: str) -> dict:
    """Registers and spilled bytes of the search kernel in a ``-Xptxas -v`` log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "nearest_code_kernel" in line:
            found = {}
            for follow in lines[i + 1:i + 4]:
                if m := re.search(r"(\d+) bytes spill stores", follow):
                    found["spill_store_bytes"] = int(m.group(1))
                if m := re.search(r"Used (\d+) registers", follow):
                    found["registers"] = int(m.group(1))
            return found
    return {}


def device_ms(fn, iters: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--first-port", type=pathlib.Path, default=None,
                        help="a source of the kernel's first port, timed beside the copies")
    parser.add_argument("--beside", type=pathlib.Path, default=None,
                        help="another revision of the kernel's source, timed beside it")
    parser.add_argument("--scale", action="store_true",
                        help="time the kernel against the units a CTA walks")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.ops.tcn_cuda import _device_limits
    from speech_separation_tpu_torch.ops.vq_cuda import nearest_code, nearest_code_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    limits = _device_limits(device)
    nvcc = _build.find_nvcc()
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = {}
    for label, (n, g, s, k) in SHAPES.items():
        inputs[label] = (torch.randn(n, g * s, generator=gen, device=device),
                         torch.randn(g, s, k, generator=gen, device=device))

    with tempfile.TemporaryDirectory(prefix="probe_vq_") as tmp:
        sources = {name: CSRC / "nearest_code.cu" for name in COPIES}
        flags = {name: defines(switches) for name, switches in COPIES.items()}
        if args.first_port is not None:
            sources["first port"], flags["first port"] = args.first_port.resolve(), ()
        if args.beside is not None:
            sources["beside"], flags["beside"] = args.beside.resolve(), ()
        paths, procs = {}, {}
        for i, name in enumerate(sources):
            paths[name] = pathlib.Path(tmp) / f"copy{i}.so"
            # stft_analysis.cu carries sst_error_string, which _build.check calls
            procs[name] = subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, *flags[name], "-Xptxas", "-v", "-shared", "-o",
                 str(paths[name]), str(sources[name]), str(CSRC / "stft_analysis.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        reports, libs = {}, {}
        for name, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on the probe copy {name!r}:\n{log}")
            reports[name] = ptxas_report(log)
            lib = ctypes.CDLL(str(paths[name]))
            lib.sst_nearest_code.argtypes = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3
                                             + (ctypes.c_void_p,) if name == "first port"
                                             else _build._SIGNATURES["sst_nearest_code"])
            lib.sst_nearest_code.restype = ctypes.c_int
            lib.sst_error_string.argtypes = (ctypes.c_int,)
            lib.sst_error_string.restype = ctypes.c_char_p
            libs[name] = lib

        @contextlib.contextmanager
        def built(name):
            """The wrapper launches the copy: the package's loaded library is swapped."""
            saved, _build._library = _build._library, libs[name]
            try:
                yield
            finally:
                _build._library = saved

        def call(name, label):
            """One search at ``label`` through copy ``name``; returns its picks."""
            flat, book = inputs[label]
            n, g, s, k = SHAPES[label]
            stream = torch.cuda.current_stream().cuda_stream
            if name == "first port":
                outs = []
                for j in range(g):
                    x = flat[:, j * s:(j + 1) * s].contiguous() if g > 1 else flat
                    out = torch.empty(n, dtype=torch.int32, device=device)
                    _build.check(libs[name].sst_nearest_code(
                        x.data_ptr(), book[j].data_ptr(), out.data_ptr(), n, s, k, stream),
                        name)
                    outs.append(out)
                return torch.stack(outs, 1)
            with built(name):
                return nearest_code(flat, book).reshape(n, g)

        # the first port times a stage's four launches on slices copied beforehand
        sliced = {j: inputs["skip stage"][0][:, j * 16:(j + 1) * 16].contiguous() for j in range(4)}

        def timed(name, label):
            if name != "first port" or label != "skip stage":
                return lambda: call(name, label)
            book = inputs[label][1]
            outs = [torch.empty(51_200, dtype=torch.int32, device=device) for _ in range(4)]

            def four():
                stream = torch.cuda.current_stream().cuda_stream
                for j in range(4):
                    _build.check(libs[name].sst_nearest_code(
                        sliced[j].data_ptr(), book[j].data_ptr(), outs[j].data_ptr(), 51_200, 16,
                        512, stream), name)
            return four

        checks = {}
        for name in sources:
            if "SKIP" not in COPIES.get(name, {}):
                checks[name] = {}
                for label, (flat, book) in inputs.items():
                    got = call(name, label)
                    want = nearest_code_plain(flat, book if SHAPES[label][1] > 1 else book[0])
                    want = want.reshape(got.shape)
                    rows, cols = (got != want).nonzero(as_tuple=True)
                    s = SHAPES[label][2]
                    x = torch.stack([flat[r, c * s:(c + 1) * s] for r, c in
                                     zip(rows.tolist(), cols.tolist())]).double() if len(rows) else None
                    bad = 0
                    for i, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
                        e = book[c].double()
                        d = lambda k: ((x[i] - e[:, k]) ** 2).sum().item()
                        scale = (x[i] ** 2).sum().item() + (e**2).sum(0).max().item()
                        bad += abs(d(int(got[r, c])) - d(int(want[r, c]))) > NEAR_TIE_REL * scale
                    if bad:
                        raise SystemExit(f"probe copy {name!r} at {label}: {bad} picks differ from "
                                         f"the plain version away from a near tie")
                    checks[name][label] = int(len(rows))
        ms = {}
        for order in (list(sources), list(reversed(sources))):
            for name in order:
                for label in SHAPES:
                    ms.setdefault(name, {}).setdefault(label, []).append(
                        device_ms(timed(name, label)))
        for name in sources:
            print(json.dumps({
                "copy": name, "flags": list(flags[name]),
                "device": torch.cuda.get_device_name(0), "smi": smi,
                "us": {label: round(1e3 * min(v), 2) for label, v in ms[name].items()},
                "runs_us": {label: [round(1e3 * t, 2) for t in v] for label, v in ms[name].items()},
                "picks_differing_from_plain": checks.get(name), **reports[name],
            }), flush=True)
    if args.scale:
        print(json.dumps({"scale": scale_fit(limits, gen, device), "smi": smi}), flush=True)
    return 0


def scale_fit(limits: dict, gen, device) -> dict:
    """The kernel's device time at D = 64, K = 512 against the units a CTA
    walks, and a least-squares line through it."""
    import torch

    from speech_separation_tpu_torch.ops.vq_cuda import SEARCH_TILE_ROWS, nearest_code

    book = torch.randn(64, 512, generator=gen, device=device)
    units = (1, 2, 4, 7, 14, 28)
    us = []
    for u in units:
        flat = torch.randn(SEARCH_TILE_ROWS * limits["sms"] * u, 64, generator=gen, device=device)
        us.append(1e3 * device_ms(lambda: nearest_code(flat, book)))
    n = len(units)
    mu, mt = sum(units) / n, sum(us) / n
    slope = (sum((u - mu) * (t - mt) for u, t in zip(units, us))
             / sum((u - mu) ** 2 for u in units))
    return {"units_a_cta": list(units), "us": [round(t, 2) for t in us],
            "us_a_unit": round(slope, 3), "us_fixed": round(mt - slope * mu, 2)}


if __name__ == "__main__":
    sys.exit(main())
