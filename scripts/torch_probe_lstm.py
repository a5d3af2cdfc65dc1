#!/usr/bin/env python3
"""Where the persistent LSTM kernels' step time goes, on one NVIDIA GPU.

    python3 scripts/torch_probe_lstm.py [--batch 32] [--serve-batch 256] [--steps 501]
                                        [--hidden 496] [--dual-rows 2048] [--dual-steps 250]
                                        [--dual-hidden 128] [--sass DIR]

Builds copies of ``csrc/lstm_train_backward.cu`` and ``csrc/lstm_recurrence.cu``
with the kernels' probe switches set by ``-D`` flags, and times each beside
the kernel itself, both directions, fp32 and bf16: the backward and the
training forward at the training bench's shape (B = 32, T = 501, H = 496), the
serving forward at the serving bench's batch (B = 256) and at DPRNN's
dual-path width (2,048 rows of 250 steps at H = 128: one launch of 16 groups
a block, walked in several passes a step).

Backward copies (``SST_BWD_*``):

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
  time, with launch bounds at two blocks an SM (128 registers a thread);
- ``bf16 256-column chunks``, ``bf16 512-column chunks``, ``bf16
  2048-column chunks``: bf16's chunk width alone changed.

Forward copies (``SST_FWD_*``), for the training forward and the serving one:

- ``kernel``; ``no product`` (h_{s-1} is loaded, not multiplied); ``no
  loads`` (h_{s-1} is not loaded, the product runs on what shared memory
  holds); ``barrier and gates only`` (neither: the per-step barrier, the xw
  loads, the gate math and the stores); and the kernel itself multiplying
  fewer groups a pass than its plan, ``N group(s) a pass`` (the same
  function, its sums split otherwise among the warps). At the dual-path
  width also ``copies not ahead`` (each pass's h_{s-1} copied at the top of
  its own pass and its xw_t loaded into registers, not both copied into
  shared memory during the pass before) and ``256-row slices`` (the plan of
  a 256-row batch, one launch a slice, one after another).

The copies that skip work compute wrong outputs by design; the others must
equal the kernel's, which the line reports. They are used for nothing else.
Prints one JSON line per kernel and compute type: milliseconds a call and
microseconds a step of each variant (the best of two passes, the variants in
one order and then in the other), and the registers a thread that ptxas gave
each copy's kernels, with the card's name and power limit. ``--sass DIR`` also
writes each copy's machine code (``cuobjdump -sass``) to ``DIR/<copy>.sass``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "speech_separation_tpu_torch" / "csrc"

BACKWARD = {
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
FORWARD = {
    "kernel": [],
    "no product": ["-DSST_FWD_SKIP_PRODUCT=1"],
    "no loads": ["-DSST_FWD_SKIP_LOADS=1"],
    "barrier and gates only": ["-DSST_FWD_SKIP_PRODUCT=1", "-DSST_FWD_SKIP_LOADS=1"],
}
# (source, variants, the variants built otherwise that compute the same outputs)
SOURCES = {
    "backward": ("lstm_train_backward.cu", BACKWARD, tuple(BACKWARD)[4:]),
    "forward": ("lstm_recurrence.cu", FORWARD, ()),
}


def registers(ptxas_log: str) -> dict:
    """Registers a thread of each LSTM kernel instance in a ``-Xptxas -v`` log,
    keyed by compute type and template arguments (``fp32``, ``bf16+keep``,
    ``fp32+train+streamed+pass2``, ``bf16+pass8+ahead``, ...)."""
    out, name = {}, None
    for line in ptxas_log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and name and "persistent_kernel" in name:
            kind = "fp32" if "kernelIf" in name else "bf16"
            flags = re.findall(r"Lb([01])E", name)
            if "lstm_fwd" in name:  # kTrain, kKeep, kResident, kPass, kAhead
                kind += "+train" * (flags[0] == "1") + "+keep" * (flags[1] == "1")
                kind += "+streamed" * (flags[2] == "0")
                kind += f"+pass{re.search(r'Li(\d+)E', name).group(1)}"
                kind += "+ahead" * (flags[3] == "1")
            else:  # kKeep
                kind += "+keep" * (flags[0] == "1")
            out[kind] = int(used.group(1))
            name = None
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--serve-batch", type=int, default=256)
    parser.add_argument("--steps", type=int, default=501)
    parser.add_argument("--hidden", type=int, default=496)
    parser.add_argument("--dual-rows", type=int, default=2048)
    parser.add_argument("--dual-steps", type=int, default=250)
    parser.add_argument("--dual-hidden", type=int, default=128)
    parser.add_argument("--sass", type=pathlib.Path, help="write each copy's SASS here")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false; this needs a GPU")
    sys.path.insert(0, str(ROOT))
    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.ops import lstm_cuda as F
    from speech_separation_tpu_torch.ops import lstm_train_cuda as L

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory(prefix="probe_lstm_") as tmp:
        libs, procs = {}, {}
        for which, (source, variants, _) in SOURCES.items():
            for i, (name, flags) in enumerate(variants.items()):
                libs[which, name] = pathlib.Path(tmp) / f"{which}{i}.so"  # nvcc splits names at commas
                procs[which, name] = subprocess.Popen(
                    [nvcc, *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-o",
                     str(libs[which, name]), str(CSRC / source)], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
        regs = {}
        for key, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on the probe copy {key!r}:\n{log}")
            regs[key] = registers(log)
            if args.sass:
                args.sass.mkdir(parents=True, exist_ok=True)
                cuobjdump = pathlib.Path(nvcc).with_name("cuobjdump")
                stem = f"{key[0]}_{key[1]}".replace(" ", "_").replace(",", "")
                (args.sass / f"{stem}.sass").write_text(
                    subprocess.run([str(cuobjdump), "-sass", str(libs[key])], capture_output=True,
                                   text=True, check=True).stdout)
        dlls = {key: ctypes.CDLL(str(path)) for key, path in libs.items()}

        def entry(key, name):
            fn = getattr(dlls[key], name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            return fn

        b, t, h = args.batch, args.steps, args.hidden
        gen = torch.Generator(device=device).manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream
        limits = L._device_limits(device)
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            bf16 = int(dtype == torch.bfloat16)
            u = (torch.randn(2, h, 4 * h, generator=gen, device=device) / h**0.5).to(dtype)
            # kernel -> (source, entry, run(fn, plan), the output to compare, plan, batch, steps)
            runs = {}

            xw = torch.randn(2, b, t, 4 * h, generator=gen, device=device).to(dtype)
            _, gates, c_all = L.lstm_train_forward(xw, u, compute_dtype=dtype)
            dy = torch.randn(b, t, 2 * h, generator=gen, device=device).to(dtype)
            dgates = torch.empty_like(gates)
            bplan = L.backward_plan(b, h, bool(bf16), **limits)

            def backward(fn, plan=bplan):
                counters = torch.zeros((2, plan.row_blocks), dtype=torch.int32, device=device)
                return fn(gates.data_ptr(), c_all.data_ptr(), dy.data_ptr(), u.data_ptr(), None,
                          dgates.data_ptr(), counters.data_ptr(), 2, b, t, h, L.REVERSE_MASK,
                          bf16, plan.groups, int(plan.resident), stream)

            runs["backward"] = ("backward", "sst_lstm_train_backward", backward, dgates, bplan, b,
                                t)

            fplan = F.forward_plan(b, h, bool(bf16), 2, **limits)
            out = torch.empty(b, t, 2 * h, dtype=dtype, device=device)
            g_out, c_out = torch.empty_like(gates), torch.empty_like(c_all)

            def train_forward(fn, plan=fplan):
                counters = torch.zeros((2, plan.row_blocks), dtype=torch.int32, device=device)
                return fn(xw.data_ptr(), u.data_ptr(), out.data_ptr(), g_out.data_ptr(),
                          c_out.data_ptr(), None, counters.data_ptr(), 2, b, 0, b, t, h,
                          L.REVERSE_MASK, bf16, plan.groups, plan.pass_groups,
                          int(plan.resident), int(plan.ahead), stream)

            runs["train forward"] = ("forward", "sst_lstm_train_forward", train_forward, out,
                                     fplan, b, t)

            def serving(rows, steps, hidden, weights):
                """The serving forward's launches at one shape: (run, output, plan)."""
                xs = torch.randn(2, rows, steps, 4 * hidden, generator=gen, device=device)
                xs = xs.to(dtype)
                s_out = torch.empty(rows, steps, 2 * hidden, dtype=dtype, device=device)

                def serve_forward(fn, plan):
                    for row0, n in plan.slices:
                        counters = torch.zeros((2, plan.row_blocks), dtype=torch.int32,
                                               device=device)
                        code = fn(xs.data_ptr(), weights.data_ptr(), s_out.data_ptr(),
                                  counters.data_ptr(), 2, rows, row0, n, steps, hidden,
                                  L.REVERSE_MASK, bf16, plan.groups, plan.pass_groups,
                                  int(plan.resident), int(plan.ahead), stream)
                        if code != 0:
                            return code
                    return 0

                return serve_forward, s_out, F.forward_plan(rows, hidden, bool(bf16), 2, **limits)

            sb = args.serve_batch
            serve_forward, s_out, splan = serving(sb, t, h, u)
            if len(splan.slices) != 1:
                raise SystemExit(f"--serve-batch {sb} needs {len(splan.slices)} launches; take "
                                 f"<= {F.launch_rows(h, 2, sms=limits['sms'])}")
            runs["serving forward"] = ("forward", "sst_lstm_recurrence", serve_forward, s_out,
                                       splan, sb, t)
            dr, dt_, dh = args.dual_rows, args.dual_steps, args.dual_hidden
            du = (torch.randn(2, dh, 4 * dh, generator=gen, device=device) / dh**0.5).to(dtype)
            dual_forward, d_out, dplan = serving(dr, dt_, dh, du)
            runs["serving forward, dual-path width"] = (
                "forward", "sst_lstm_recurrence", dual_forward, d_out, dplan, dr, dt_)
            # the same kernel in the plan a 256-row batch gets, one launch a
            # 256-row slice; its sums are the plan's where the groups a pass are
            sliced = dataclasses.replace(F.forward_plan(min(dr, F.FWD_MAX_ROWS), dh, bool(bf16), 2,
                                                        **limits), slices=F.row_slices(dr))

            for kernel, (which, c_name, run, result, plan, batch, steps) in runs.items():
                variants, exact_names = SOURCES[which][1], SOURCES[which][2]
                fns = {name: (entry((which, name), c_name), plan) for name in variants}
                exact_names = set(exact_names)
                if which == "forward":  # the kernel with other launch plans
                    kernel_fn = entry((which, "kernel"), c_name)
                    for p in (1, 2, 4):
                        if p < plan.pass_groups:
                            fns[f"{p} group(s) a pass"] = (kernel_fn, dataclasses.replace(
                                plan, pass_groups=p, ahead=plan.ahead and p > 1))
                    if plan.ahead:
                        fns["copies not ahead"] = (kernel_fn,
                                                   dataclasses.replace(plan, ahead=False))
                        exact_names.add("copies not ahead")
                    if plan is dplan:
                        fns["256-row slices"] = (kernel_fn, sliced)
                        if sliced.pass_groups == plan.pass_groups:
                            exact_names.add("256-row slices")

                def call(name):
                    code = run(*fns[name])
                    if code != 0:
                        raise RuntimeError(f"probe launch {kernel} {name!r}: CUDA error {code}")

                call("kernel")
                want = result.clone()
                times, exact = {}, {}
                for order in (list(fns), list(reversed(fns))):
                    for name in order:
                        call(name)
                        if name in exact_names:
                            exact[name] = torch.equal(result, want)
                        torch.cuda.synchronize()
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(5):
                            call(name)
                        end.record()
                        torch.cuda.synchronize()
                        times.setdefault(name, []).append(start.elapsed_time(end) / 5)
                print(json.dumps({
                    "kernel": kernel, "dtype": tag, "batch": batch, "steps": steps,
                    "hidden": dh if plan is dplan else h, "smi": smi,
                    "plan": {"groups": plan.groups, "resident": plan.resident, "smem": plan.smem,
                             "blocks": plan.blocks, "ahead": getattr(plan, "ahead", None),
                             "launches": len(getattr(plan, "slices", ((0, batch),)))},
                    "ms": {k: min(v) for k, v in times.items()},
                    "us_per_step": {k: 1e3 * min(v) / steps for k, v in times.items()},
                    "plan_pass_groups": getattr(plan, "pass_groups", None),
                    "registers": {k: {kind: n for kind, n in regs[which, k].items()
                                      if kind.startswith(tag)} for k in variants},
                    "equal_to_kernel": exact,
                }), flush=True)
            del xw, gates, c_all, dy, dgates, out, s_out, d_out, g_out, c_out, runs
            del serve_forward, dual_forward
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
