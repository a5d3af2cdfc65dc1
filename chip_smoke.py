#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is non-zero):

1. device — requires ``torch.cuda.is_available()``; prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN (the DSP runs in fp32);
2. build  — compiles ``speech_separation_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a into the package's ``.kernel_build/``;
3. kernels against their plain PyTorch versions on the card: the STFT
   analysis kernel at (16, 64000) fp32, and the LSTM recurrence at full width
   (H=496, B=16, T=501, both directions) in fp32 and bf16;
4. main path — ``separate_directory`` over the ``tt`` split of a synthetic
   fixture with the full-width ``UPitBlstm`` (16,077,602 random parameters
   from seed 0), in fp32 and bf16, counting each kernel's launches; then the
   kernel path against the plain path on one padded batch;
5. timing — the bench shape (256 utterances × 8 s at 8 kHz), kernel path and
   plain path in fp32 and bf16, and each kernel alone against its plain version.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

SAMPLE_RATE = 8000
BENCH_BATCH = 256
BENCH_SECONDS = 8.0
STFT_TOL = 1e-4  # fp32 FMA against cuBLAS fp32: both full fp32, sums in another order
LSTM_TOL = 1e-4  # fp32 kernel against the fp32 plain loop over 501 steps
# bf16 operands (xw, U, and h before each product; 8-bit mantissa, ~4e-3
# relative) with the fp32 carry, against the fp32 plain loop
LSTM_BF16_TOL = 3e-2
PATH_REL_TOL = 1e-4  # relative L2, kernel path against plain path, fp32


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls, after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a GPU")

    from speech_separation_tpu_torch import _build
    from speech_separation_tpu_torch.data.audio_io import read_wav
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.ops.lstm_cuda import lstm_recurrence, lstm_recurrence_plain
    from speech_separation_tpu_torch.ops.stft import stft, stft_frame_count
    from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda
    from speech_separation_tpu_torch.separate.pipeline import (
        make_separate_fn,
        separate_directory,
        separated_length,
    )

    # 1. device
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    phase("device", f"{name} | nvidia-smi: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | tf32 off")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    phase("build", f"nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"{' '.join(s.name for s in _build.SOURCES)}: {time.perf_counter() - t0:.1f} s")

    # 3. kernels against their plain versions
    gen = torch.Generator(device=device).manual_seed(0)
    sig = torch.randn(16, 64000, generator=gen, device=device)
    spec = stft_cuda(sig)
    stft_err = (spec - stft(sig)).abs().max().item()
    fft_err = (spec - stft(sig, method="fft")).abs().max().item()  # independent oracle
    torch.cuda.synchronize()
    if not max(stft_err, fft_err) <= STFT_TOL:
        raise AssertionError(f"stft_cuda max abs err {stft_err} (fft oracle {fft_err}) > {STFT_TOL}")
    phase("kernels", f"stft_analysis (16, 64000) fp32: max abs err {stft_err:.3e} against the "
          f"plain matmul, {fft_err:.3e} against the fft oracle, <= {STFT_TOL}")

    model = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 16_077_602:
        raise AssertionError(f"UPitBlstm has {n_params} params, expected 16,077,602")
    hidden = 496
    u = model.bilstm_0.cells.recurrent_kernel.detach()
    xw = torch.randn(2, 16, 501, 4 * hidden, generator=gen, device=device)
    rev = (False, True)
    with torch.inference_mode():
        want = lstm_recurrence_plain(xw, u, reverse=rev)
        lstm_err = (lstm_recurrence(xw, u, reverse=rev) - want).abs().max().item()
        lstm_err_bf16 = (
            lstm_recurrence(xw, u, reverse=rev, compute_dtype=torch.bfloat16).float() - want
        ).abs().max().item()
    torch.cuda.synchronize()
    if not lstm_err <= LSTM_TOL:
        raise AssertionError(f"lstm_recurrence fp32 max abs err {lstm_err} > {LSTM_TOL}")
    if not lstm_err_bf16 <= LSTM_BF16_TOL:
        raise AssertionError(f"lstm_recurrence bf16 max abs err {lstm_err_bf16} > {LSTM_BF16_TOL}")
    phase("kernels", f"lstm_recurrence H=496 B=16 T=501 D=2: fp32 max abs err "
          f"{lstm_err:.3e} <= {LSTM_TOL}; bf16 against fp32 plain {lstm_err_bf16:.3e} "
          f"<= {LSTM_BF16_TOL} (bf16 operands, fp32 carry)")

    # 4. main path: separate a directory at full width, fp32 and bf16
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = make_synthetic_fixture(
            pathlib.Path(tmp) / "fixture", utterances_per_split={"tr": 1, "cv": 1, "tt": 8}
        )
        split = root / "tt"
        names = [n for n in (root / "lists" / "tt_wav.lst").read_text().split()]
        runs = {"fp32": None, "bf16": torch.bfloat16}
        stft_cuda.launches = 0
        lstm_recurrence.launches = 0
        t0 = time.perf_counter()
        written = {
            tag: separate_directory(
                model, split, pathlib.Path(tmp) / f"sep_{tag}", batch_size=4, compute_dtype=dt
            )
            for tag, dt in runs.items()
        }
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"stft_analysis": stft_cuda.launches, "lstm_recurrence": lstm_recurrence.launches}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the main path never launched: {launches}")
        for tag, paths in written.items():
            if len(paths) != 2 * len(names) or not all(p.exists() for p in paths):
                raise AssertionError(f"{tag}: wrote {len(paths)} wavs for {len(names)} mixtures")
            for n in names:
                mix, _ = read_wav(split / "mix" / n)
                frames = stft_frame_count(len(mix), 256, 128)
                for s in (1, 2):
                    est, _ = read_wav(pathlib.Path(tmp) / f"sep_{tag}" / f"{n[:-4]}_s{s}.wav")
                    if len(est) != separated_length(frames, 256, 128):
                        raise AssertionError(f"{tag}: {n} s{s} has {len(est)} samples")
        phase("main", f"separate_directory tt ({len(names)} mixtures, UPitBlstm "
              f"{n_params:,} params) fp32 + bf16: {sum(map(len, written.values()))} wavs "
              f"in {seconds:.2f} s; launches {launches}")

        batch = next(iter(WaveformLoader(split, batch_size=4)))
        mix = torch.from_numpy(batch.mix).to(device)
        lens = torch.from_numpy(batch.frame_lengths).to(device)
        plain = make_separate_fn(model, plain=True)(mix, lens)
        for tag, dt in runs.items():
            got = make_separate_fn(model, compute_dtype=dt)(mix, lens)
            if got.shape != plain.shape or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{tag}: output {tuple(got.shape)} not finite or misshaped")
            rel = ((got - plain).norm() / plain.norm()).item()
            if tag == "fp32" and not rel <= PATH_REL_TOL:
                raise AssertionError(f"kernel path vs plain path rel L2 {rel} > {PATH_REL_TOL}")
            phase("main", f"{tag} kernel path against fp32 plain path on one batch "
                  f"{tuple(mix.shape)}: rel L2 {rel:.3e}, finite, shape {tuple(got.shape)}")

    # 5. timing at the bench shape
    samples = int(BENCH_SECONDS * SAMPLE_RATE)
    mix = 0.1 * torch.randn(BENCH_BATCH, samples, generator=gen, device=device)
    frames = stft_frame_count(samples, 256, 128)
    lens = torch.full((BENCH_BATCH,), frames, dtype=torch.int32, device=device)
    audio_s = BENCH_BATCH * BENCH_SECONDS
    path_ms = {}
    for tag, dt in runs.items():
        for kind in ("plain", "kernel", "kernel", "plain"):
            fn = make_separate_fn(model, compute_dtype=dt, plain=kind == "plain")
            path_ms.setdefault((tag, kind), []).append(cuda_ms(lambda: fn(mix, lens), iters=5))
    for (tag, kind), vals in path_ms.items():
        ms = min(vals)
        phase("timing", f"separate {tag} {kind} path, {BENCH_BATCH} x {BENCH_SECONDS:.0f} s: "
              f"{ms:.2f} ms/batch = {audio_s / (ms / 1e3):,.0f}x real time "
              f"(runs {', '.join(f'{v:.2f}' for v in vals)} ms)")

    sig = mix
    stft_ms = cuda_ms(lambda: stft_cuda(sig), iters=20)
    stft_plain_ms = cuda_ms(lambda: stft(sig), iters=20)
    phase("timing", f"stft_analysis ({BENCH_BATCH}, {samples}) fp32: kernel {stft_ms:.3f} ms, "
          f"plain {stft_plain_ms:.3f} ms")
    lstm_ms = {}
    xw = torch.randn(2, BENCH_BATCH, frames, 4 * hidden, generator=gen, device=device)
    with torch.inference_mode():
        for tag, dt in runs.items():
            x, w = xw.to(dt or torch.float32), u.to(dt or torch.float32)
            lstm_ms[tag] = (
                cuda_ms(lambda: lstm_recurrence(x, w, reverse=rev), iters=5),
                cuda_ms(lambda: lstm_recurrence_plain(x, w, reverse=rev), iters=5),
            )
            phase("timing", f"lstm_recurrence {tag} D=2 B={BENCH_BATCH} T={frames} H={hidden}: "
                  f"kernel {lstm_ms[tag][0]:.2f} ms, plain {lstm_ms[tag][1]:.2f} ms")

    kernels = [
        {
            "name": "stft_analysis",
            "route": "cuda",
            "source": "speech_separation_tpu_torch/csrc/stft_analysis.cu",
            "replaces": "speech_separation_tpu/ops/stft_pallas.py:177",
            "launches": launches["stft_analysis"],
            "max_abs_err": stft_err,
            "ms": stft_ms,
            "plain_ms": stft_plain_ms,
        },
        {
            "name": "lstm_recurrence",
            "route": "cuda",
            "source": "speech_separation_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "speech_separation_tpu/ops/lstm_pallas.py:131",
            "launches": launches["lstm_recurrence"],
            "max_abs_err": lstm_err,
            "ms": lstm_ms["fp32"][0],
            "plain_ms": lstm_ms["fp32"][1],
            "max_abs_err_bf16": lstm_err_bf16,
            "ms_bf16": lstm_ms["bf16"][0],
            "plain_ms_bf16": lstm_ms["bf16"][1],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
