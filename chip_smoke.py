#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one line each (any failed check raises and the exit code is non-zero):

1. device — requires ``torch.cuda.is_available()``; prints the card's name and
   power limit; turns TF32 off for matmuls and cuDNN (the DSP runs in fp32,
   and the codec's codes are argmins over fp32 distances, which TF32 in its
   encoder's convolutions would move across near ties);
2. build  — compiles ``speech_separation_tpu_torch/csrc/*.cu`` with nvcc for
   sm_90a into the package's ``.kernel_build/`` (one nvcc per source, together);
3. kernels against their plain PyTorch versions on the card: the STFT
   analysis kernel (a real FFT) at (16, 64000) fp32 at size 256 with fading
   and at size 1024 without, against the matmul plain version, the
   ``torch.fft`` oracle and ``stft_fft_plain`` (the kernel's algorithm in
   PyTorch), the result a view of the kernel's buffer; and the persistent
   LSTM recurrence (T=501) at full width (H=496, both directions) at B=16,
   at the serving batch B=256 and at B=300 (two row slices, two launches a
   call), at a ragged B=3, H=20 and in one direction, in fp32 and bf16, each
   against its plain loop and rerun bit-identical;
4. serving path — ``separate_directory`` over the ``tt`` split of a synthetic
   fixture with the full-width ``UPitBlstm`` (16,077,602 random parameters
   from seed 0), in fp32 and bf16, counting each kernel's launches (the LSTM
   recurrence: one a call per row slice); then the kernel path against the
   plain path on one padded batch;
5. serving timing — the bench shape (256 utterances × 8 s at 8 kHz), kernel
   path and plain path in fp32 and bf16, each serving kernel alone against its
   plain version (the STFT also against ``torch.stft`` and its bound; the
   LSTM in microseconds a step), and the port's BiLSTM layer forward (cuBLAS
   projection + kernel) alternated with cuDNN's, which does the same work;
6. training kernels against their plain versions at full width (H=496, B=16,
   T=501, both directions), fp32 and bf16, with and without a keep gate with
   segment breaks: the forward's h, gates and c, the backward's dgates (and at
   B=64, two row blocks of the persistent kernel; the forward also at B=32,
   B=64 and B=256), every rerun bit-identical, and ``bilstm_train``'s four
   gradients against autograd through a plain loop;
7. training path — the port's ``cli train`` for 2 epochs on a synthetic
   fixture (tr 8, cv 4) at full width, fp32 and bf16, then ``cli separate
   --checkpoint-dir`` on ``tt``, counting each kernel's launches (the forward
   kernels: one a call per row slice); the kernel path's train step against
   the plain path's on one batch; 8 steps on one fixed batch must lower the
   loss;
8. training timing — ``bench_blstm_train``'s shape (32 utterances × 8 s,
   T=501): the train step, kernel path against plain path in fp32 and bf16,
   in audio-seconds trained per second, and each training kernel alone
   against its plain version, also in microseconds a step (the timed
   training forward's outputs held against the plain version in fp32 and
   bf16, rerun bit-identical); cuDNN's
   bidirectional layer forward and backward, each alternated with
   ``bilstm_train``'s whole forward (projection and kernel) or whole backward
   (the kernel and its four gradient products), the same work;
9. the Conv-TasNet trunk kernel against its plain version at full width
   (cb 128, ch 256, 21 blocks, dilations 1 to 64) at B=4 × K=8000 frames and
   a ragged K=8003, at B=7 × K=3000 (more items than its plan keeps in
   flight) and B=3 × K=50 (below the dilation-64 halo), weights from the full-width ``ConvTasNet``
   (2,226,092 random parameters from seed 0, norms, biases and slopes
   perturbed), with a bit-identical rerun;
10. Conv-TasNet serving path — a port checkpoint of that model, then ``cli
   separate --kernel pallas`` over the ``tt`` split of a synthetic fixture (8
   mixtures), counting the trunk kernel's launches; on one batch,
   ``cuda_apply`` against the fp32 module and against ``cuda_apply`` with the
   plain trunk, the fp32 module against ``fused_apply`` in fp32; a causal
   checkpoint with ``--kernel pallas`` must exit non-zero;
11. Conv-TasNet timing at ``bench.py::bench_tasnet``'s shape (64 × 8 s,
   ``default_rng(0)`` normal × 0.1), win 16 and 32: the module in fp32 and
   bf16 and ``cuda_apply`` (kernel and plain trunk) in ×-real-time, and the
   trunk kernel alone against its plain version, its timed output held
   against the plain trunk (rerun bit-identical), the device operations of
   one call under the profiler (one trunk kernel launch) and the kernel's
   time by part of a block (its ``%globaltimer`` laps);
12. the Conv-TasNet training kernels against their plain versions at full
   width (B=4, cb 128, ch 256, 21 blocks) at K=4000 frames
   (``bench_tasnet_train``'s 4 s at win 16) and a ragged K=4003: the
   forward's skip sum (≡ the serving kernel's, bit for bit), saved h and each
   statistic column; the backward's dh0, three weight gradients and each used
   row of dvec on the same residuals, and the kernel chain against the plain
   chain; bit-identical reruns; the same at the backward plan's edges, B=7 ×
   K=3000 (several tiles a CTA), B=140 × K=50 (more items than SMs: a group
   walks two), B=3 × K=50 (below the dilation-64 halo) and B=1 × K=4000, the
   forward's statistics at K=50 held against each plain block run on the
   kernel's own saved input (against the plain chain's, reported); and the
   plain passes in fp32 storage against autograd through ``trunk_reference``;
13. Conv-TasNet training path — ``cli train`` with ``variant="tasnet"``,
   ``tasnet_pallas_trunk=true`` for 2 epochs on a synthetic fixture (tr 8,
   cv 4) at full width, then ``cli separate --kernel pallas`` from its
   checkpoint, counting the three trunk kernels' launches; on one batch the
   kernel path's loss and gradients against the plain trunk's and the bf16
   module's; 8 steps on one fixed batch must lower the loss;
14. Conv-TasNet training timing at ``bench_tasnet_train``'s shape (16 × 4 s,
   win 16): the train step of the kernel path, the plain-trunk path and the
   module's autograd in fp32 and bf16, in audio-seconds trained per second,
   and each training kernel alone against its plain version, the timed
   calls' outputs held to phase 12's bounds (reruns bit-identical), the device
   operations of one backward call under the profiler (one backward kernel
   launch) and both kernels' time by part of a block;
15. the nearest-code kernel against its plain version at the codec's shapes
   (t3tok at 64 x 8 s: deep N=12,800 D=64 K=512, one skip group N=51,200
   D=16 K=512, and a skip stage as one grouped call, 4 groups of S=16 read in
   place from a wider residual), a ragged N=12,803 G=3 S=13 K=509 and a
   codebook streamed past the shared memory (N=700 D=256 K=1,024), every
   differing pick a near tie by float64 distances, reruns bit-identical; a
   duplicated codebook, where every exact tie must pick the lower index;
16. the codec path — the committed trained t3tok (``params_ep38.npz``) as a
   port checkpoint, then ``cli codec-encode``, ``codec-decode`` and
   ``codec-roundtrip`` on 4 hard-profile utterances, the reconstruction's
   SI-SDR from codes alone; ``cli train --workload vqvae --variant t3tok``
   for 2 epochs (tr 8, cv 4) at the JAX defaults and ``codec-roundtrip`` from
   its checkpoint, counting the kernel's launches; on one batch the kernel
   path's codes and reconstruction against the plain path's; 8 steps on one
   fixed batch must lower the loss;
17. codec timing: ``codes``, the deterministic forward (kernel and plain
   paths) and ``decode_codes`` at 64 x 8 s in x-real-time, the t3tok train
   step at 8 x 8 s (the committed run's batch size) in audio-seconds trained
   per second; one ``codes`` call under the profiler (4 kernel launches: 2
   deep and 2 skip stages) and the kernel's device time in it; and the kernel
   alone at the deep, one-group skip and grouped skip-stage shapes against its
   plain version, on the device (queued behind a sleep kernel) and paced by
   the host, the timed calls' own outputs held against the plain version's;
18. packed training path — ``cli train`` with ``pack=true`` for 2 epochs on a
   synthetic fixture (tr 24, cv 8) at full width, fp32 and bf16, rows of 16
   s packed 2 a batch, then ``cli separate --checkpoint-dir`` on ``tt``,
   counting the kernels' launches: every training forward and 3 backward
   launches a step in the keep mode of rows 3 and 4, none without the gate,
   no plain loop; on one packed batch the kernel path's loss and four
   gradient groups against the plain path's, the packed loss against the
   sum over its utterances run alone, ``forward(segment_ids)`` (the training
   forward kernel's keep mode) against ``train_forward`` and the plain path;
   8 steps on one fixed batch must lower the loss;
19. packed training timing at the JAX loader's defaults (16 rows x 16 s,
   1,001 frames): the train step, kernel path in fp32 and bf16 and plain
   path in fp32, in audio-seconds trained per second counting only the true
   audio, with the batch's frame occupancy and phase 8's bucketed rate;
20. scoring — ``cli evaluate`` on the ``tt`` output of phases 4, 7, 10, 13
   and 18, each JSON line finite and equal to ``evaluate_directory`` in
   process; then the overfit quality run of ``scripts/fixture_quality_run.py``
   on a synthetic fixture: the full-width ``UPitBlstm`` in fp32 trained 500
   steps on one batch of 4 easy-profile utterances, that split separated and
   scored (SI-SDR, SI-SDRi, BSS SDR) beside the untrained model's; the
   SI-SDRi must gain at least 3 dB.

Phase 15 also holds the search's NaN picks: a NaN score orders below every
number, so a row holding one gets its first NaN's index, as ``torch.argmin``
and ``jnp.argmin`` pick it (a NaN codebook column; a row holding an inf
against a code with a 0 there), resident and streamed, 2-D and grouped.

Every kernel's entry in the kernels line carries its bound: the larger of its
compulsory bytes (each input read once, each output written once) over 3.35
TB/s and the operations its function needs over the peak for their type (989
TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32), NVIDIA's H100 SXM figures
(for the STFT a real FFT's ~2.5 N log2 N per frame; for the nearest-code search 2 N D K fp32 operations
against 4 (N D + D K + N) bytes); and the time of one PyTorch call computing
the same function where there is one (``torch.stft``, cuDNN ``nn.LSTM``),
used nowhere in the port.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

SAMPLE_RATE = 8000
BENCH_BATCH = 256
BENCH_SECONDS = 8.0
# the real FFT against the dense fp32 DFT (cuBLAS, TF32 off) and torch.fft:
# all fp32, the sums taken in other orders (the JAX package's STFT bound)
STFT_TOL = 1e-4
LSTM_TOL = 1e-4  # fp32 kernel against the fp32 plain loop over 501 steps
# bf16 operands (xw, U, and h before each product; 8-bit mantissa, ~4e-3
# relative) with the fp32 carry, against the fp32 plain loop
LSTM_BF16_TOL = 3e-2
PATH_REL_TOL = 1e-4  # relative L2, kernel path against plain path, fp32
TRAIN_BATCH = 32  # bench.py::bench_blstm_train: 32 utterances x 8 s
# Training kernels against their plain versions on the same inputs. fp32: the
# same operations, sums in another order. bf16: both sides round gates, h and
# dgates to bf16 at the same places; a sum whose last bit differs can flip
# one rounding by a bf16 ulp (2^-8 relative), which the recurrence carries a
# few steps, so the bound is 3e-2 of the largest magnitude (at least 1).
TRAIN_TOL = 1e-4
TRAIN_BF16_TOL = 3e-2
GRAD_REL_TOL = 1e-4  # relative L2 of bilstm_train's fp32 gradients against autograd
STEP_REL_TOL = 1e-5  # fp32 loss, kernel path against plain path
TASNET_BATCH = 64  # bench.py::bench_tasnet: 64 utterances x 8 s
# The trunk kernel against its plain version: both store h, skip, t1 and t2
# in bf16 at the same places; a sum in another order flips one bf16 rounding
# (2^-8 relative), which later blocks carry, so 3e-2 of the largest |skip|.
TRUNK_BF16_TOL = 3e-2
SERVE_DB = 22.0  # cuda_apply (bf16) against the fp32 module: the JAX bound
# cuda_apply with the kernel trunk against the plain trunk, both bf16: only
# the trunk's summation order differs, so tighter than against fp32
TRUNK_PATH_DB = 30.0
FUSED_DB = 90.0  # the fp32 module against fused_apply fp32: the same math
TASNET_TRAIN_BATCH, TASNET_TRAIN_SECONDS = 16, 4.0  # bench.py::bench_tasnet_train
# The training backward kernel against its plain version on the same residuals:
# both round seven slabs to bf16 and sum over (K, ch) in another order, so a
# flipped rounding moves a gradient by a bf16 ulp of its summands (2^-8);
# relative L2 of each gradient, and of each used row of dvec on its own (the
# rows' scales differ, so a wrong row could hide in the whole). Measured at
# most 7.7e-3 (H100 80GB HBM3, 700 W).
TRAIN_TRUNK_GRAD_REL = 3e-2
# The saved statistics, each column (mu1, 1/sigma1, mu2, 1/sigma2) on its own:
# means over an item's 1M elements of t1 and t2, which differ from the plain
# version's by a few flipped bf16 roundings. Measured 1.7e-5 over all four.
TRAIN_TRUNK_STATS_REL = 1e-4
# Below the dilation-64 halo (K = 50) a block's statistics are means over
# 12,800 values, so a few bf16 flips that the chain carries through earlier
# blocks move them more (1.5e-4 to 2.4e-4 rel L2 against the plain chain's).
# They are held against each plain block run on the kernel's own saved input
# hb[j], where only the block's own summation order and the flips it makes
# itself differ: the same 1e-4.
TRAIN_TRUNK_OWN_STATS_REL = 1e-4
STAT_COLUMNS = ("mu1", "1/sigma1", "mu2", "1/sigma2")
DVEC_ROWS = (0, 1, 2, 3, 4, 5, 6, 8, 9)  # stack_canonical's rows; row 7 is unused
# The chain, kernel forward then kernel backward, against plain forward then
# plain backward: the residuals differ too (h by flipped bf16 roundings that
# 21 blocks carry), so what the saved residuals feed the backward shows here
# and not above. That is bf16 noise of the size that puts either chain 0.11
# to 0.13 (rel L2) from float64 autograd; the chains measured 0.08 to 0.094
# apart (H100 80GB HBM3, 700 W), so the bound is 0.2.
TRAIN_TRUNK_CHAIN_REL = 0.2
# The plain passes in fp32 storage against autograd through trunk_reference in
# float64: the same function, derived by hand (the CPU tests measure ~125 dB
# at 6 narrow blocks). At full width fp32 rounding alone moves the gradients
# by ~1e-3 (21 blocks, gLN groups of 1M elements): the bound is twice the fp32
# trunk_reference's own distance from float64, at least 1e-5.
TRAIN_TRUNK_FP32_FACTOR = 2.0
# One batch: the kernel path's loss against the plain trunk's (bf16 both;
# only the trunk's summation order differs) and the bf16 module's (roundings
# at other places); gradients as SNR over all parameters, bf16 pairs
TASNET_STEP_LOSS_REL = {"plain trunk": 1e-2, "module bf16": 5e-2}
# (measured 48.2 and 32.0 dB, H100 80GB HBM3, 700 W)
TASNET_STEP_GRAD_DB = {"plain trunk": 35.0, "module bf16": 10.0}
# Packed training: the JAX loader's defaults (data/packing.py), the row of
# 16 s holding 1,001 STFT frames; phase 18's cli run packs 2 rows a batch
PACK_ROWS, PACK_ROW_SECONDS = 16, 16.0
# The packed loss against the sum of pit_loss over the same utterances run
# unpacked, fp32 kernel path: the same frames, sums in another order
PACKED_SUM_REL = 1e-4
# The overfit protocol of scripts/fixture_quality_run.py: 500 steps on one
# batch of 4 utterances, train == test; the trained SI-SDRi must beat the
# untrained model's by this much
QUALITY_STEPS, QUALITY_GAIN_DB = 500, 3.0
# NVIDIA H100 SXM: HBM bytes/s, dense bf16 tensor-core and fp32 FLOP/s
HBM_BYTES_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12


def bound(nbytes: float, flops: float, peak: float) -> dict:
    """The least time for ``nbytes`` of compulsory traffic and ``flops`` at ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


@contextlib.contextmanager
def counting_calls(module, name: str):
    """Count the calls made through ``module.name`` while the block runs: the
    name is bound to a counting wrapper and restored after. Rebind it only in
    a module that calls the function, not the one that defines it (the
    wrappers count their launches on their own module-level name). Yields the
    count as a one-item list."""
    fn, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def keep_output(kept: pathlib.Path, tag: str, root: pathlib.Path, est: pathlib.Path) -> None:
    """Copy a fixture's ``tt`` split and a path's estimates of it to
    ``kept/tag`` for phase 20's scoring."""
    shutil.copytree(root / "tt", kept / tag / "data" / "tt")
    shutil.copytree(est, kept / tag / "est")


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
    from speech_separation_tpu_torch.models import blstm as blstm_module
    from speech_separation_tpu_torch.models.blstm import BiLSTM
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.ops.lstm_cuda import (
        lstm_recurrence,
        lstm_recurrence_plain,
        row_slices,
    )
    from speech_separation_tpu_torch.ops.stft import stft, stft_frame_count
    from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda, stft_fft_plain
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

    # the tt outputs of phases 4, 7, 10, 13 and 18, scored in phase 20
    kept_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_scored_")
    kept = pathlib.Path(kept_dir.name)

    # 3. kernels against their plain versions
    gen = torch.Generator(device=device).manual_seed(0)
    sig = torch.randn(16, 64000, generator=gen, device=device)
    stft_err = 0.0
    for size, fading in ((256, True), (1024, False)):
        args = (sig, size, size // 2)
        spec = stft_cuda(*args, fading=fading)
        errs = {"matmul plain": stft(*args, fading=fading),
                "torch.fft oracle": stft(*args, fading=fading, method="fft"),
                "stft_fft_plain": stft_fft_plain(*args, fading=fading)}
        errs = {what: (spec - want).abs().max().item() for what, want in errs.items()}
        torch.cuda.synchronize()
        is_view = spec._base is not None and spec._base.shape == (*spec.shape, 2)
        if not (max(errs.values()) <= STFT_TOL and is_view):
            raise AssertionError(f"stft_cuda size {size}: max abs err {errs} (<= {STFT_TOL}), "
                                 f"a view of the kernel's buffer {is_view}")
        stft_err = max(stft_err, errs["matmul plain"])
        phase("kernels", f"stft_analysis (16, 64000) fp32 size {size} fading {fading}: max abs err "
              + ", ".join(f"{v:.3e} against the {k}" for k, v in errs.items())
              + f" <= {STFT_TOL}; the result is a view of the kernel's [B, F, bins, 2] buffer")

    model = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 16_077_602:
        raise AssertionError(f"UPitBlstm has {n_params} params, expected 16,077,602")
    hidden = 496
    u = model.bilstm_0.cells.recurrent_kernel.detach()
    rev = (False, True)
    # (D, B, H): the full width at B = 16, the serving batch, two row slices,
    # a ragged B and H (rows not 16-byte aligned), one direction
    lstm_err = {"fp32": 0.0, "bf16": 0.0}
    for dirs, b, h in ((2, 16, hidden), (2, BENCH_BATCH, hidden), (2, 300, hidden), (2, 3, 20),
                       (1, 16, hidden)):
        w = (u[:dirs] if h == hidden
             else torch.randn(dirs, h, 4 * h, generator=gen, device=device) / h**0.5)
        xw = torch.randn(dirs, b, 501, 4 * h, generator=gen, device=device)
        reverse = rev if dirs == 2 else (True,)
        slices = len(row_slices(b))
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            with torch.inference_mode():
                want = lstm_recurrence_plain(xw, w, reverse=reverse, compute_dtype=dt)
                before = lstm_recurrence.launches
                got = lstm_recurrence(xw, w, reverse=reverse, compute_dtype=dt)
                again = lstm_recurrence(xw, w, reverse=reverse, compute_dtype=dt)
            torch.cuda.synchronize()
            launched = lstm_recurrence.launches - before
            err = max_err([got], [want])
            lim = (LSTM_TOL if tag == "fp32"
                   else LSTM_BF16_TOL * max(1.0, want.float().abs().max().item()))
            if not (err <= lim and torch.equal(got, again) and launched == 2 * slices):
                raise AssertionError(
                    f"lstm_recurrence D={dirs} B={b} H={h} {tag}: max abs err {err} (bound "
                    f"{lim}), rerun bit-identical {torch.equal(got, again)}, {launched} launches "
                    f"for 2 calls of {slices} row slices")
            lstm_err[tag] = max(lstm_err[tag], err)
            phase("kernels", f"lstm_recurrence {tag} D={dirs} B={b} T=501 H={h}: max abs err "
                  f"{err:.3e} <= {lim:.3e} against the {tag} plain loop, rerun bit-identical, "
                  f"{launched // 2} launch(es) a call ({slices} row slice(s))")
        del xw, want, got, again

    # 4. serving path: separate a directory at full width, fp32 and bf16
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
        with counting_calls(blstm_module, "lstm_recurrence") as calls:
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
            raise AssertionError(f"a kernel of the serving path never launched: {launches}")
        # batches of 4 are one row slice each: one launch a call
        if launches["lstm_recurrence"] != calls[0]:
            raise AssertionError(f"lstm_recurrence: {launches['lstm_recurrence']} launches for "
                                 f"{calls[0]} calls of one row slice each")
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
        phase("serve", f"separate_directory tt ({len(names)} mixtures, UPitBlstm "
              f"{n_params:,} params) fp32 + bf16: {sum(map(len, written.values()))} wavs "
              f"in {seconds:.2f} s; launches {launches}, lstm_recurrence one a call "
              f"({calls[0]} calls)")

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
            phase("serve", f"{tag} kernel path against fp32 plain path on one batch "
                  f"{tuple(mix.shape)}: rel L2 {rel:.3e}, finite, shape {tuple(got.shape)}")
        keep_output(kept, "phase 4 separate_directory fp32", root, pathlib.Path(tmp) / "sep_fp32")

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
    window = torch.blackman_window(256, periodic=False, device=device)
    stft_lib_ms = cuda_ms(lambda: torch.stft(sig, 256, 128, window=window, center=True,
                                             pad_mode="constant", return_complex=True), iters=20)
    stft_frames = stft_frame_count(samples, 256, 128)
    stft_bound = bound(4 * BENCH_BATCH * (samples + stft_frames * 258),
                       BENCH_BATCH * stft_frames * (256 + 2.5 * 256 * math.log2(256)), FP32_FLOPS)
    phase("timing", f"stft_analysis ({BENCH_BATCH}, {samples}) fp32: kernel {stft_ms:.4f} ms "
          f"({100 * stft_bound['bound_ms'] / stft_ms:.1f}% of its {stft_bound['bound_ms']:.4f} ms "
          f"bound by {stft_bound['bound_by']}), plain {stft_plain_ms:.3f} ms, torch.stft (cuFFT) "
          f"{stft_lib_ms:.4f} ms")
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
                  f"kernel {lstm_ms[tag][0]:.3f} ms ({1e3 * lstm_ms[tag][0] / frames:.2f} us a "
                  f"step, one persistent launch), plain {lstm_ms[tag][1]:.2f} ms")
        # cuDNN's bidirectional layer at the same shape, fp32; it also computes
        # the input projection x @ W (input 2H, the model's layers 2 and 3),
        # which the kernel's caller leaves to cuBLAS: the same work on the
        # port's side is the BiLSTM layer's forward (projection + kernel). The
        # two alternate, and each keeps its best of two captures.
        cudnn = torch.nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True).to(device)
        layer = BiLSTM(2 * hidden, hidden, generator=torch.Generator().manual_seed(1)).to(device)
        x_in = torch.randn(BENCH_BATCH, frames, 2 * hidden, generator=gen, device=device)
        fwd_ms = {}
        for which in ("cudnn", "port", "port", "cudnn"):
            fn = (lambda: cudnn(x_in)) if which == "cudnn" else (lambda: layer(x_in))
            fwd_ms.setdefault(which, []).append(cuda_ms(fn, iters=5))
        lstm_lib_ms, lstm_layer_ms = min(fwd_ms["cudnn"]), min(fwd_ms["port"])
        del cudnn, layer, x_in
    phase("timing", f"cuDNN nn.LSTM fp32 bidirectional B={BENCH_BATCH} T={frames} H={hidden} "
          f"(input 2H, projection included): {lstm_lib_ms:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in fwd_ms['cudnn'])}); the port's BiLSTM layer forward, "
          f"the same work (cuBLAS projection + lstm_recurrence): {lstm_layer_ms:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in fwd_ms['port'])})")

    train, bucketed = training_phases(device, model, gen, kept)
    del model
    torch.cuda.empty_cache()
    tasnet = tasnet_phases(device, gen, kept)
    torch.cuda.empty_cache()
    tasnet_train = tasnet_training_phases(device, gen, kept)
    torch.cuda.empty_cache()
    codec = codec_phases(device, gen)
    torch.cuda.empty_cache()
    packed = packed_phases(device, kept, bucketed)
    torch.cuda.empty_cache()
    scoring_phases(device, kept)
    kept_dir.cleanup()
    for entry in train:  # rows 3 and 4: their keep-mode launches on the packed path
        entry.update(packed[entry["name"]])

    d, h4 = 2, 4 * hidden
    lstm_bytes = 4 * (d * BENCH_BATCH * frames * h4 + d * hidden * h4 + BENCH_BATCH * frames * d * hidden)

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
            # the window's 256 products and a 256-point real FFT per frame
            **stft_bound,
            "library_ms": stft_lib_ms,
        },
        {
            "name": "lstm_recurrence",
            "route": "cuda",
            "source": "speech_separation_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "speech_separation_tpu/ops/lstm_pallas.py:131",
            "launches": launches["lstm_recurrence"],
            "max_abs_err": lstm_err["fp32"],
            "ms": lstm_ms["fp32"][0],
            "plain_ms": lstm_ms["fp32"][1],
            **bound(lstm_bytes, 2 * d * BENCH_BATCH * frames * hidden * h4, FP32_FLOPS),
            "library_ms": lstm_lib_ms,
            "max_abs_err_bf16": lstm_err["bf16"],
            "ms_bf16": lstm_ms["bf16"][0],
            "plain_ms_bf16": lstm_ms["bf16"][1],
            "us_per_step": 1e3 * lstm_ms["fp32"][0] / frames,
            "us_per_step_bf16": 1e3 * lstm_ms["bf16"][0] / frames,
            # library_ms (cuDNN) includes the input projection; this is the
            # port's side of that work
            "layer_forward_ms": lstm_layer_ms,
        },
        *train,
        tasnet,
        *tasnet_train,
        codec,
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def snr_db(ref, est) -> float:
    import torch

    return (10 * torch.log10(ref.double().square().sum()
                             / (ref.double() - est.double()).square().sum().clamp_min(1e-30))).item()


def check_trunk(h0, stacks, dils) -> tuple[float, float, float]:
    """``tcn_trunk_cuda`` at h0 against ``tcn_trunk_plain`` within 3e-2 x
    max(1, max |skip|), rerun bit-identical; raises if not. Returns (max abs
    error, bound, max |skip|)."""
    import torch

    from speech_separation_tpu_torch.ops.tcn_cuda import tcn_trunk_cuda, tcn_trunk_plain

    got = tcn_trunk_cuda(h0, *stacks, dils=dils)
    again = tcn_trunk_cuda(h0, *stacks, dils=dils)
    want = tcn_trunk_plain(h0, *stacks, dils=dils)
    torch.cuda.synchronize()
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    bound = TRUNK_BF16_TOL * max(1.0, peak)
    same = torch.equal(got, again)
    if got.shape != want.shape or not err <= bound or not same:
        raise AssertionError(f"tcn_trunk {tuple(h0.shape)}: shape {tuple(got.shape)}, max abs err "
                             f"{err} (bound {bound}), rerun identical {same}")
    return err, bound, peak


def tasnet_phases(device, gen, kept) -> dict:
    """Phases 9 to 11; returns the trunk kernel's entry of the kernels line."""
    import copy

    import numpy as np
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.audio_io import read_wav
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.models.tasnet_serving import cuda_apply, fused_apply
    from speech_separation_tpu_torch.ops.tcn_cuda import _device_limits as trunk_limits
    from speech_separation_tpu_torch.ops.tcn_cuda import (
        TRUNK_LAPS,
        stack_tcn_weights,
        tcn_trunk_cuda,
        tcn_trunk_plain,
        trunk_phase_ms,
        trunk_plan,
    )
    from speech_separation_tpu_torch.utils import UPitTrainConfig, save_config

    dils = tuple(2**x for _ in range(3) for x in range(7))

    # 9. the trunk kernel against its plain version at full width
    model = full_width_tasnet(device)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 2_226_092:
        raise AssertionError(f"ConvTasNet has {n_params} params, expected 2,226,092")
    stacks = stack_tcn_weights(dict(model.state_dict()), blocks=7, repeats=3)
    trunk_err = 0.0
    before = tcn_trunk_cuda.launches
    # the bench's frames and a ragged K; a batch past the items the plan keeps
    # in flight (several items a group); K below the largest dilation's halo
    for batch, frames in ((4, 8000), (4, 8003), (7, 3000), (3, 50)):
        h0 = torch.randn(batch, frames, 128, generator=gen, device=device)
        err, bound, peak = check_trunk(h0, stacks, dils)
        trunk_err = max(trunk_err, err)
        plan = trunk_plan(batch, frames, 128, 256, 3, dils, **trunk_limits(device))
        phase("tasnet-kernel", f"tcn_trunk B={batch} K={frames} cb=128 ch=256 21 blocks bf16 "
              f"({plan.groups} items in flight, {plan.ctas} CTAs an item): max abs err {err:.3e} "
              f"<= {bound:.3e} (3e-2 x max |skip| {peak:.2f}); rerun bit-identical")
    phase("tasnet-kernel", f"tcn_trunk launches in these checks: {tcn_trunk_cuda.launches - before}"
          " (two calls each)")

    # 10. serving path through the port's CLI at full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tasnet_") as tmp:
        tmp = pathlib.Path(tmp)
        root = make_synthetic_fixture(tmp / "fixture", utterances_per_split={"tr": 1, "cv": 1, "tt": 8})
        for name, causal in (("ckpt", False), ("ckpt_causal", True)):
            m = model if not causal else full_width_tasnet(device, causal=True)
            state = train_mod.TrainState.create(m, train_mod.adam(), seed=0)
            train_mod.CheckpointManager(tmp / name).save_if_best(0, state, 0.0)
            save_config(UPitTrainConfig(variant="tasnet", seed=0, batch_size=4, tasnet_causal=causal),
                        tmp / name / "train_config.json")
        out = tmp / "sep"
        tcn_trunk_cuda.launches = 0
        t0 = time.perf_counter()
        cli.main(["separate", "--checkpoint-dir", str(tmp / "ckpt"), "--data-root", str(root),
                  "--out-dir", str(out), "--kernel", "pallas"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = tcn_trunk_cuda.launches
        if launches <= 0:
            raise AssertionError("tcn_trunk never launched in cli separate --kernel pallas")
        names = (root / "lists" / "tt_wav.lst").read_text().split()
        wavs = sorted(out.glob("*.wav"))
        if len(wavs) != 2 * len(names):
            raise AssertionError(f"cli separate wrote {len(wavs)} wavs for {len(names)} mixtures")
        for n in names:
            mix, _ = read_wav(root / "tt" / "mix" / n)
            for s in (1, 2):
                est, _ = read_wav(out / f"{n[:-4]}_s{s}.wav")
                if len(est) != len(mix) or not np.isfinite(est).all():
                    raise AssertionError(f"{n} s{s}: {len(est)} samples for a {len(mix)}-sample mix")
        phase("tasnet-serve", f"cli separate --kernel pallas tt ({len(names)} mixtures, ConvTasNet "
              f"{n_params:,} params): {len(wavs)} wavs of their mixtures' lengths in "
              f"{seconds:.2f} s; tcn_trunk launches {launches}")
        keep_output(kept, "phase 10 Conv-TasNet cli separate --kernel pallas", root, out)

        batch = next(iter(WaveformLoader(root / "tt", batch_size=4)))
        mix = torch.from_numpy(batch.mix).to(device)
        with torch.no_grad():
            ref = model(mix)
        got = cuda_apply(model, mix)
        plain = cuda_apply(model, mix, plain=True)
        fused = fused_apply(model, mix, dtype=None)
        torch.cuda.synchronize()
        snrs = {"cuda_apply vs fp32 module": (snr_db(ref, got), SERVE_DB),
                "cuda_apply vs plain trunk": (snr_db(plain, got), TRUNK_PATH_DB),
                "fp32 module vs fused_apply fp32": (snr_db(ref, fused), FUSED_DB)}
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"cuda_apply output {tuple(got.shape)} not finite or misshaped")
        for what, (value, bound) in snrs.items():
            if not value >= bound:
                raise AssertionError(f"{what}: SNR {value:.2f} dB < {bound} dB")
        phase("tasnet-serve", f"one batch {tuple(mix.shape)}: " + "; ".join(
            f"{what} {value:.2f} dB >= {bound}" for what, (value, bound) in snrs.items()))

        try:
            cli.main(["separate", "--checkpoint-dir", str(tmp / "ckpt_causal"), "--data-root",
                      str(root), "--out-dir", str(tmp / "sep_causal"), "--kernel", "pallas"])
        except SystemExit as exc:
            if exc.code in (0, None):
                raise AssertionError(f"causal checkpoint with --kernel pallas exited {exc.code!r}")
            phase("tasnet-serve", f"causal checkpoint with --kernel pallas refused: {exc.code}")
        else:
            raise AssertionError("a causal checkpoint ran through --kernel pallas")
    del model, stacks

    # 11. timing at bench_tasnet's shape
    samples = int(BENCH_SECONDS * SAMPLE_RATE)
    mix = torch.from_numpy(
        np.random.default_rng(0).standard_normal((TASNET_BATCH, samples)).astype(np.float32) * 0.1
    ).to(device)
    audio_s = TASNET_BATCH * BENCH_SECONDS
    trunk_ms, trunk_launches = {}, {}
    for win in (16, 32):
        m = full_width_tasnet(device, win)
        m16 = copy.deepcopy(m).to(torch.bfloat16)
        paths = {
            "module fp32": lambda: m(mix),
            "module bf16": lambda: m16(mix),
            "cuda_apply plain trunk": lambda: cuda_apply(m, mix, plain=True),
            "cuda_apply": lambda: cuda_apply(m, mix),
        }
        times = {}
        with torch.inference_mode():
            for order in (list(paths), list(reversed(paths))):
                for what in order:
                    times.setdefault(what, []).append(cuda_ms(paths[what], iters=3))
        for what, vals in times.items():
            ms = min(vals)
            phase("tasnet-timing", f"win {win} {what}, {TASNET_BATCH} x {BENCH_SECONDS:.0f} s: "
                  f"{ms:.2f} ms/batch = {audio_s / (ms / 1e3):,.0f}x real time "
                  f"(runs {', '.join(f'{v:.2f}' for v in vals)} ms)")
        k = samples // (win // 2)
        st = stack_tcn_weights(dict(m.state_dict()), blocks=7, repeats=3)
        h0 = torch.randn(TASNET_BATCH, k, 128, generator=gen, device=device).to(torch.bfloat16)
        runs = {"plain": [], "kernel": []}
        for kind in ("plain", "kernel", "kernel", "plain"):
            fn = tcn_trunk_plain if kind == "plain" else tcn_trunk_cuda
            runs[kind].append(cuda_ms(lambda: fn(h0, *st, dils=dils), iters=3))
        trunk_ms[win] = (min(runs["kernel"]), min(runs["plain"]))
        flops = 2 * TASNET_BATCH * k * 21 * (128 * 256 + 256 * 256)
        b_ = trunk_bound(TASNET_BATCH, k)
        phase("tasnet-timing", f"tcn_trunk win {win} B={TASNET_BATCH} K={k}: kernel "
              f"{trunk_ms[win][0]:.2f} ms ({flops / trunk_ms[win][0] / 1e9:.1f} TFLOP/s in the "
              f"1x1 products; bound {b_['bound_ms']:.3f} ms by {b_['bound_by']}, "
              f"{100 * b_['bound_ms'] / trunk_ms[win][0]:.1f}%), plain {trunk_ms[win][1]:.2f} ms "
              f"(runs kernel {', '.join(f'{v:.2f}' for v in runs['kernel'])}; plain "
              f"{', '.join(f'{v:.2f}' for v in runs['plain'])})")
        # the timed calls' output against the plain trunk, rerun bit-identical
        err, bound, peak = check_trunk(h0, st, dils)
        trunk_err = max(trunk_err, err)
        # what one call launches on the device, and where the kernel's time goes
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            tcn_trunk_cuda(h0, *st, dils=dils)
            torch.cuda.synchronize()
        device_ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        kernel_ops = [n for n in device_ops if "trunk_kernel" in n]
        trunk_launches[win] = len(kernel_ops)
        phases = trunk_phase_ms(h0, *st, dils=dils)
        phase("tasnet-timing", f"tcn_trunk win {win}: the timed output against the plain trunk, "
              f"max abs err {err:.3e} <= {bound:.3e} (3e-2 x max |skip| {peak:.2f}), rerun "
              f"bit-identical; one call: {len(kernel_ops)} trunk kernel launch ({phases['groups']} "
              f"groups x {phases['ctas']} CTAs) of {len(device_ops)} device operations "
              f"({', '.join(sorted(set(n[:40] for n in device_ops)))}); mean ms a CTA "
              "(%globaltimer): " + ", ".join(
                  f"{p_} {phases[p_]:.3f}" for p_ in TRUNK_LAPS))
        if len(kernel_ops) != 1:
            raise AssertionError(f"tcn_trunk: {len(kernel_ops)} trunk kernel launches a call")
        del m, m16, st, h0
        torch.cuda.empty_cache()

    return {
        "name": "tcn_trunk",
        "route": "cuda",
        "source": "speech_separation_tpu_torch/csrc/tcn_trunk.cu",
        "replaces": "speech_separation_tpu/ops/tcn_pallas.py:280",
        "launches": launches,
        "max_abs_err": trunk_err,
        "ms": trunk_ms[16][0],
        "plain_ms": trunk_ms[16][1],
        **trunk_bound(TASNET_BATCH, samples // 8),
        "library_ms": None,
        "ms_win32": trunk_ms[32][0],
        "plain_ms_win32": trunk_ms[32][1],
        "kernel_launches_per_call": trunk_launches[16],
    }


TRUNK_CB, TRUNK_CH, TRUNK_BLOCKS, TRUNK_TAPS = 128, 256, 21, 3


def trunk_bound(batch: int, frames: int, train: str = "") -> dict:
    """Bound of the trunk kernels at (batch, frames), full width: bf16 products
    (the depthwise taps' fp32 work is < 1% of it), compulsory bytes h0 and the
    weights in, skip out; ``train="forward"`` adds the saved h and statistics,
    ``"backward"`` reads those and dskip (fp32) and writes dh0 (fp32) and the
    gradients, with five products a block (14 B K cb ch)."""
    cb, ch, n = TRUNK_CB, TRUNK_CH, TRUNK_BLOCKS
    vdim = max(ch, 2 * cb)
    bk = batch * frames
    weights = n * (2 * (cb * ch + ch * 2 * cb) + 4 * (TRUNK_TAPS * ch + 10 * vdim))
    if train == "backward":
        grads = 4 * n * (cb * ch + TRUNK_TAPS * ch + ch * 2 * cb + 10 * vdim)
        nbytes = 4 * bk * cb + 2 * n * bk * cb + 16 * n * batch + weights + 4 * bk * cb + grads
        return bound(nbytes, 14 * n * bk * cb * ch, BF16_FLOPS)
    nbytes = 2 * bk * cb + weights + 2 * bk * cb
    if train == "forward":
        nbytes += 2 * n * bk * cb + 16 * n * batch
    return bound(nbytes, 2 * n * bk * (cb * ch + ch * 2 * cb), BF16_FLOPS)


def full_width_tasnet(device, win: int = 16, causal: bool = False):
    """The full-width ConvTasNet from seed 0, norms, biases and slopes perturbed
    from seed 1 (init leaves gamma 1, beta and biases 0: the folds need more)."""
    import torch

    from speech_separation_tpu_torch.models.tasnet import ConvTasNet

    m = ConvTasNet(win=win, causal=causal, generator=torch.Generator().manual_seed(0))
    pert = torch.Generator().manual_seed(1)
    scale = {"gamma": 0.2, "beta": 0.1, "bias": 0.1, "alpha": 0.05}
    with torch.no_grad():
        for name, p in m.named_parameters():
            sc = scale.get(name.rsplit(".", 1)[-1])
            if sc:
                p += sc * torch.randn(p.shape, generator=pert)
    return m.to(device).eval()


def rel_l2(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30)).item()


GRAD_NAMES = ("dh0", "dwe", "dwdw", "dwcat", "dvec")


def rel_l2_parts(name, got, want):
    """rel L2 of a trunk gradient; for ``dvec``, a dict of it per used row."""
    if name != "dvec":
        return rel_l2(got, want)
    return {row: rel_l2(got[:, row], want[:, row]) for row in DVEC_ROWS}


def flat_parts(parts: dict) -> dict:
    """``{"dh0": x, ..., "dvec": {0: x, ...}}`` as ``{"dh0": x, ..., "dvec[0]": x, ...}``."""
    out = {}
    for name, v in parts.items():
        out.update({f"{name}[{row}]": r for row, r in v.items()} if isinstance(v, dict) else {name: v})
    return out


def own_input_stats(hb, folded, dils):
    """Each block's statistics ``[N, B, 4]`` from the plain block run alone on
    ``hb[j]``, the input the kernel saved for it."""
    import torch

    from speech_separation_tpu_torch.ops.tcn_cuda import trunk_forward_plain

    return torch.stack([
        trunk_forward_plain(hb[j], *(t[j:j + 1] for t in folded), dils=(d,), residuals=True)[2][0]
        for j, d in enumerate(dils)])


def check_training_trunk(h0, dskip, canon, folded, dils, *, serving: bool = False,
                         hold_stats: bool = True) -> dict:
    """The training kernels at (h0, dskip) against their plain versions: the
    forward's skip and saved h (max abs, 3e-2 x max(1, peak)) and each
    statistic column (rel L2 against the plain chain's; without
    ``hold_stats`` reported, and held instead against each plain block on the
    kernel's own saved input, :func:`own_input_stats`);
    the backward on the kernel's residuals against the plain backward on the
    same (rel L2 per gradient and used dvec row), and the kernel chain against
    the plain chain; both kernels rerun bit-identical, and with ``serving``
    the forward's skip equal to ``tcn_trunk_cuda``'s. Raises if any is out of
    bounds; returns the errors, the scales they are of, the largest gradient
    rel L2 and a report."""
    import torch

    from speech_separation_tpu_torch.ops.tcn_cuda import tcn_trunk_cuda
    from speech_separation_tpu_torch.ops.tcn_train_cuda import (
        tcn_train_backward,
        tcn_train_backward_plain,
        tcn_train_forward,
        tcn_train_forward_plain,
    )

    skip, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    fwd_again = tcn_train_forward(h0, *folded, dils=dils)
    want = tcn_train_forward_plain(h0, *folded, dils=dils)
    grads = tcn_train_backward(dskip, hb, st, *canon, dils=dils)
    again = tcn_train_backward(dskip, hb, st, *canon, dils=dils)
    plain = tcn_train_backward_plain(dskip, hb, st, *canon, dils=dils)
    chain = tcn_train_backward_plain(dskip, want[1], want[2], *canon, dils=dils)
    torch.cuda.synchronize()
    if serving and not torch.equal(skip, tcn_trunk_cuda(h0, *folded, dils=dils)):
        raise AssertionError(f"tcn_train_forward {tuple(h0.shape)}: skip differs from tcn_trunk")
    fwd = {}
    for what, got, ref in (("skip", skip, want[0]), ("h", hb, want[1])):
        peak = ref.float().abs().max().item()
        fwd[what] = ((got.float() - ref.float()).abs().max().item(), TRUNK_BF16_TOL * max(1.0, peak))
    for i, col in enumerate(STAT_COLUMNS):
        fwd[col] = (rel_l2(st[..., i], want[2][..., i]), TRAIN_TRUNK_STATS_REL)
    if not hold_stats:
        own = own_input_stats(hb, folded, dils)
        for i, col in enumerate(STAT_COLUMNS):
            fwd[f"{col} (own input)"] = (rel_l2(st[..., i], own[..., i]), TRAIN_TRUNK_OWN_STATS_REL)
    bwd = {name: rel_l2_parts(name, g, r) for name, g, r in zip(GRAD_NAMES, grads, plain)}
    chained = {name: rel_l2_parts(name, g, r) for name, g, r in zip(GRAD_NAMES, grads, chain)}
    held = [k for k in fwd if hold_stats or k in ("skip", "h") or k.endswith("(own input)")]
    bad = {k: fwd[k] for k in held if not fwd[k][0] <= fwd[k][1]}
    bad.update({f"backward {k}": v for k, v in flat_parts(bwd).items()
                if not v <= TRAIN_TRUNK_GRAD_REL})
    bad.update({f"chain {k}": v for k, v in flat_parts(chained).items()
                if not v <= TRAIN_TRUNK_CHAIN_REL})
    if grads[4][:, 7].any():
        bad["dvec[7] (unused) not zero"] = grads[4][:, 7].abs().max().item()
    same = {"forward": all(torch.equal(a, b) for a, b in zip((skip, hb, st), fwd_again)),
            "backward": all(torch.equal(a, b) for a, b in zip(grads, again))}
    if bad or not all(same.values()):
        raise AssertionError(f"training trunk {tuple(h0.shape)}: out of bounds {bad}, reruns "
                             f"bit-identical {same}")
    report = (("forward skip ≡ tcn_trunk bit for bit; " if serving else "") + "forward vs plain: "
              + "; ".join(f"{k} {v[0]:.3e} {'<=' if v[0] <= v[1] else '>'} {v[1]:.3e}"
                          for k, v in fwd.items())
              + " (skip, h max abs, 3e-2 x max(1, peak); statistics rel L2 per column"
              + ("" if hold_stats else ", against the plain chain's reported, against the "
                 "plain blocks on the kernel's own input held") + "); backward "
              f"on the same residuals, rel L2 <= {TRAIN_TRUNK_GRAD_REL}: "
              + "; ".join(f"{k} {v:.2e}" for k, v in flat_parts(bwd).items())
              + f"; kernel chain against plain chain, rel L2 <= {TRAIN_TRUNK_CHAIN_REL}: "
              + "; ".join(f"{k} {v:.2e}" for k, v in flat_parts(chained).items())
              + "; reruns of both bit-identical")
    return {"err": {"forward": fwd["skip"][0], "backward": max_err(grads, plain)},
            "scale": {"forward": want[0].float().abs().max().item(),
                      "backward": max(r.abs().max().item() for r in plain)},
            "grad_rel": max(flat_parts(bwd).values()), "report": report}


def tasnet_training_phases(device, gen, kept) -> list[dict]:
    """Phases 12 to 14; returns the two training kernels' entries of the kernels line."""
    import numpy as np
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.losses import pit_si_sdr_loss
    from speech_separation_tpu_torch.models.tasnet_serving import train_apply
    from speech_separation_tpu_torch.ops.tcn_cuda import (
        TRUNK_LAPS,
        fold_canonical,
        stack_canonical,
        tcn_trunk_cuda,
        trunk_phase_ms,
        trunk_reference,
    )
    from speech_separation_tpu_torch.ops.tcn_train_cuda import (
        TRUNK_BWD_LAPS,
        tcn_train_backward,
        tcn_train_backward_plain,
        tcn_train_forward,
        tcn_train_forward_plain,
        tcn_trunk_train,
        trunk_backward_phase_ms,
    )

    dils = tuple(2**x for _ in range(3) for x in range(7))
    model = full_width_tasnet(device)
    canon = stack_canonical(dict(model.state_dict()), blocks=7, repeats=3)
    folded = fold_canonical(*canon)

    # 12. the training kernels against their plain versions at full width
    errs = {"forward": 0.0, "backward": 0.0}
    scale = {"forward": 0.0, "backward": 0.0}  # the largest |value| the errors are of
    grad_rel = 0.0
    for frames in (4000, 4003):
        h0 = torch.randn(4, frames, TRUNK_CB, generator=gen, device=device)
        dskip = torch.randn(4, frames, TRUNK_CB, generator=gen, device=device)
        found = check_training_trunk(h0, dskip, canon, folded, dils, serving=True)
        for which in errs:
            errs[which] = max(errs[which], found["err"][which])
            scale[which] = max(scale[which], found["scale"][which])
        grad_rel = max(grad_rel, found["grad_rel"])
        phase("tasnet-train-kernels", f"B=4 K={frames} cb=128 ch=256 21 blocks bf16: "
              + found["report"])
        del h0, dskip, found
    # the backward plan's edges: several tiles a CTA (B=7), more items than
    # SMs (B=140: a group walks two, adding to its partials), items below the
    # dilation-64 halo (where the forward's statistics of 12,800 values a
    # block are held against the plain blocks on the kernel's own input, the
    # plain chain's reported), one item
    for batch, frames in ((7, 3000), (140, 50), (3, 50), (1, 4000)):
        h0 = torch.randn(batch, frames, TRUNK_CB, generator=gen, device=device)
        dskip = torch.randn(batch, frames, TRUNK_CB, generator=gen, device=device)
        found = check_training_trunk(h0, dskip, canon, folded, dils, hold_stats=frames >= 3000)
        for which in errs:
            errs[which] = max(errs[which], found["err"][which])
            scale[which] = max(scale[which], found["scale"][which])
        grad_rel = max(grad_rel, found["grad_rel"])
        phase("tasnet-train-kernels", f"B={batch} K={frames} cb=128 ch=256 21 blocks bf16: "
              + found["report"])
        del h0, dskip, found

    h0 = torch.randn(4, 4003, TRUNK_CB, generator=gen, device=device)
    probe = torch.randn(4, 4003, TRUNK_CB, generator=gen, device=device)
    runs = {}
    for kind in ("float64", "reference", "fp32", "kernel"):
        dtype = torch.float64 if kind == "float64" else torch.float32
        params = [t.detach().to(dtype).clone().requires_grad_() for t in (h0, *canon)]
        if kind in ("float64", "reference"):
            out = trunk_reference(*params, dils=dils)
        else:
            out = tcn_trunk_train(*params, dils=dils, plain=kind == "fp32",
                                  storage=torch.float32 if kind == "fp32" else torch.bfloat16)
        (out.to(dtype) * probe.to(dtype)).sum().backward()
        # the PReLU rows' lanes summed, as stack_canonical sums them
        g = [p.grad for p in params]
        g[4] = torch.cat([g[4][:, :8].flatten(), g[4][:, 8:].sum(-1).flatten()])
        runs[kind] = g
    oracle = runs.pop("float64")
    rels = {kind: [rel_l2(a, b) for a, b in zip(g, oracle)] for kind, g in runs.items()}
    bounds = [max(1e-5, TRAIN_TRUNK_FP32_FACTOR * r) for r in rels["reference"]]
    if not all(r <= b for r, b in zip(rels["fp32"], bounds)):
        raise AssertionError(f"fp32 plain trunk gradients against float64 autograd: rel L2 "
                             f"{rels['fp32']}, bounds {bounds}")
    phase("tasnet-train-kernels", "B=4 K=4003 against autograd through trunk_reference in float64,"
          " rel L2 of " + ", ".join(GRAD_NAMES) + ": plain passes in fp32 storage " + ", ".join(
              f"{r:.2e} <= {b:.2e}" for r, b in zip(rels["fp32"], bounds))
          + "; trunk_reference fp32 " + ", ".join(f"{r:.2e}" for r in rels["reference"])
          + "; kernels (bf16) " + ", ".join(f"{r:.2e}" for r in rels["kernel"]))
    del runs, h0, probe

    # 13. the training path through the port's CLI at full width
    counters = (tcn_train_forward, tcn_train_backward, tcn_trunk_cuda)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tasnet_train_") as tmp:
        tmp = pathlib.Path(tmp)
        root = make_synthetic_fixture(tmp / "fixture", utterances_per_split={"tr": 8, "cv": 4, "tt": 4})
        cfg = tmp / "cfg.json"
        cfg.write_text(json.dumps({"variant": "tasnet", "tasnet_pallas_trunk": True, "seed": 0,
                                   "batch_size": 4, "learning_rate": 1e-3}))
        ckpt, out = tmp / "ckpt", tmp / "sep"
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        cli.main(["train", "--config", str(cfg), "--data-root", str(root), "--epochs", "2",
                  "--checkpoint-dir", str(ckpt), "--device", "cuda"])
        cli.main(["separate", "--checkpoint-dir", str(ckpt), "--data-root", str(root),
                  "--out-dir", str(out), "--kernel", "pallas", "--device", "cuda"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the Conv-TasNet training path never launched: {launches}")
        records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in records if "loss" in r]
        vals = [r["val_loss"] for r in records if "val_loss" in r]
        if len(losses) != 4 or len(vals) != 2 or not all(map(math.isfinite, losses + vals)):
            raise AssertionError(f"cli train tasnet: step losses {losses}, val losses {vals}")
        if not list(ckpt.glob("ckpt_*.pt")) or len(list(out.glob("*.wav"))) != 8:
            raise AssertionError(f"cli train/separate tasnet: {sorted(ckpt.iterdir())}, "
                                 f"{len(list(out.glob('*.wav')))} wavs for 4 mixtures")
        phase("tasnet-train", f"cli train tasnet (ConvTasNet 2,226,092 params, tasnet_pallas_trunk) "
              f"2 epochs of tr 8 (batch 4) + cv 4: step losses "
              f"{', '.join(f'{v:.2f}' for v in losses)}; val {', '.join(f'{v:.2f}' for v in vals)}; "
              f"then cli separate --kernel pallas (8 wavs), {seconds:.1f} s; launches {launches}")

        keep_output(kept, "phase 13 Conv-TasNet cli train + separate", root, out)
        b = next(iter(WaveformLoader(root / "tr", batch_size=4)))
        arrays = tuple(torch.from_numpy(a).to(device) for a in (b.mix, b.sources, b.sample_lengths))

    def loss_and_grads(kind):
        net = full_width_tasnet(device)
        if kind == "module bf16":
            cast = {n: p.to(torch.bfloat16) for n, p in net.named_parameters()}
            est = torch.func.functional_call(net, cast, (arrays[0],))
        else:
            est = train_apply(net, arrays[0], plain=kind == "plain trunk")
        loss = pit_si_sdr_loss(est.float(), arrays[1], arrays[2])
        loss.backward()
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).flatten()
                          for p in net.parameters()])
        return loss.item(), flat

    k_loss, k_grad = loss_and_grads("kernel")
    parts = []
    for kind in ("plain trunk", "module bf16"):
        loss, grad = loss_and_grads(kind)
        rel, db = abs(k_loss - loss) / abs(loss), snr_db(grad, k_grad)
        if not (rel <= TASNET_STEP_LOSS_REL[kind] and db >= TASNET_STEP_GRAD_DB[kind]):
            raise AssertionError(f"kernel path vs {kind}: loss {k_loss} vs {loss} (rel {rel}), "
                                 f"gradient SNR {db} dB")
        parts.append(f"vs {kind} loss {loss:.4f} (rel {rel:.1e} <= {TASNET_STEP_LOSS_REL[kind]}), "
                     f"gradients {db:.1f} dB >= {TASNET_STEP_GRAD_DB[kind]}")
    phase("tasnet-train", f"one batch {tuple(arrays[0].shape)}, kernel path loss {k_loss:.4f}: "
          + "; ".join(parts))

    net = full_width_tasnet(device)
    state = train_mod.TrainState.create(net, train_mod.adam(1e-3), seed=0)
    ts, _ = train_mod.make_time_domain_steps(net, compute_dtype=torch.bfloat16, pallas_trunk=True)
    fixed = [ts(state, *arrays)[1].item() for _ in range(8)]
    if not (all(map(math.isfinite, fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError(f"8 kernel-path steps on one batch did not lower the loss: {fixed}")
    phase("tasnet-train", f"8 kernel-path steps (adam 1e-3) on one fixed batch: loss "
          f"{fixed[0]:.2f} -> {fixed[-1]:.2f}")
    del net, state, ts

    # 14. training timing at bench_tasnet_train's shape
    samples = int(TASNET_TRAIN_SECONDS * SAMPLE_RATE)
    src = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (TASNET_TRAIN_BATCH, 2, samples)).astype(np.float32) * 0.1).to(device)
    batch = (src.sum(1), src, torch.full((TASNET_TRAIN_BATCH,), samples, dtype=torch.int32,
                                         device=device))
    audio_s = TASNET_TRAIN_BATCH * TASNET_TRAIN_SECONDS
    settings = {"kernel path": dict(compute_dtype=torch.bfloat16, pallas_trunk=True),
                "plain-trunk path": dict(compute_dtype=torch.bfloat16, pallas_trunk=True, plain=True),
                "module bf16": dict(compute_dtype=torch.bfloat16),
                "module fp32": dict()}
    step_ms = {}
    for order in (list(settings), list(reversed(settings))):
        for what in order:
            net = full_width_tasnet(device)
            state = train_mod.TrainState.create(net, train_mod.adam(1e-3), seed=0)
            ts, _ = train_mod.make_time_domain_steps(net, **settings[what])
            step_ms.setdefault(what, []).append(cuda_ms(lambda: ts(state, *batch), iters=3))
            del net, state, ts
    for what, vals in step_ms.items():
        ms = min(vals)
        phase("tasnet-train-timing", f"train step {what}, {TASNET_TRAIN_BATCH} x "
              f"{TASNET_TRAIN_SECONDS:.0f} s: {ms:.1f} ms/step = {audio_s / (ms / 1e3):,.1f} "
              f"audio-s trained per s (runs {', '.join(f'{v:.1f}' for v in vals)} ms)")

    k = samples // 8
    h0 = torch.randn(TASNET_TRAIN_BATCH, k, TRUNK_CB, generator=gen, device=device)
    dskip = torch.randn(TASNET_TRAIN_BATCH, k, TRUNK_CB, generator=gen, device=device)
    _, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    fns = {
        "forward": (lambda: tcn_train_forward(h0, *folded, dils=dils),
                    lambda: tcn_train_forward_plain(h0, *folded, dils=dils)),
        "backward": (lambda: tcn_train_backward(dskip, hb, st, *canon, dils=dils),
                     lambda: tcn_train_backward_plain(dskip, hb, st, *canon, dils=dils)),
    }
    kernel_ms = {}
    for which, (kernel_fn, plain_fn) in fns.items():
        runs = {"plain": [], "kernel": []}
        for kind in ("plain", "kernel", "kernel", "plain"):
            runs[kind].append(cuda_ms(kernel_fn if kind == "kernel" else plain_fn, iters=3))
        kernel_ms[which] = (min(runs["kernel"]), min(runs["plain"]))
        b_ = trunk_bound(TASNET_TRAIN_BATCH, k, which)
        phase("tasnet-train-timing", f"tcn_train_{which} B={TASNET_TRAIN_BATCH} K={k}: kernel "
              f"{kernel_ms[which][0]:.2f} ms (bound {b_['bound_ms']:.3f} ms by {b_['bound_by']}, "
              f"{100 * b_['bound_ms'] / kernel_ms[which][0]:.1f}%), plain {kernel_ms[which][1]:.2f} ms "
              f"(runs kernel {', '.join(f'{v:.2f}' for v in runs['kernel'])}; plain "
              f"{', '.join(f'{v:.2f}' for v in runs['plain'])})")
    del hb, st
    # the timed calls' outputs against their plain versions, phase 12's bounds
    timed = check_training_trunk(h0, dskip, canon, folded, dils)
    phase("tasnet-train-timing", f"the timed tcn_train_forward and tcn_train_backward, "
          f"B={TASNET_TRAIN_BATCH} K={k}: " + timed["report"])
    fwd_phases = trunk_phase_ms(h0, *folded, dils=dils, residuals=True)
    phase("tasnet-train-timing", f"tcn_train_forward B={TASNET_TRAIN_BATCH} K={k}: one "
          f"cooperative launch of {fwd_phases['groups']} groups x {fwd_phases['ctas']} CTAs; mean "
          "ms a CTA (%globaltimer): " + ", ".join(
              f"{p_} {fwd_phases[p_]:.3f}" for p_ in TRUNK_LAPS))
    # what one backward call launches on the device, and where its time goes
    _, hb, st = tcn_train_forward(h0, *folded, dils=dils)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tcn_train_backward(dskip, hb, st, *canon, dils=dils)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    bwd_kernels = [n for n in device_ops if "backward_kernel" in n]
    bwd_phases = trunk_backward_phase_ms(dskip, hb, st, *canon, dils=dils)
    phase("tasnet-train-timing", f"tcn_train_backward B={TASNET_TRAIN_BATCH} K={k}: one call: "
          f"{len(bwd_kernels)} backward kernel launch ({bwd_phases['groups']} groups x "
          f"{bwd_phases['ctas']} CTAs, cooperative) of {len(device_ops)} device operations "
          f"({', '.join(sorted(set(n[:40] for n in device_ops)))}); mean ms a CTA "
          "(%globaltimer): " + ", ".join(f"{p_} {bwd_phases[p_]:.3f}" for p_ in TRUNK_BWD_LAPS))
    if len(bwd_kernels) != 1:
        raise AssertionError(f"tcn_train_backward: {len(bwd_kernels)} kernel launches a call")
    del hb, st
    del model, canon, folded, h0, dskip
    torch.cuda.empty_cache()

    return [
        {
            "name": f"tcn_train_{which}",
            "route": "cuda",
            "source": "speech_separation_tpu_torch/csrc/"
                      + ("tcn_trunk.cu" if which == "forward" else "tcn_train_backward.cu"),
            "replaces": f"speech_separation_tpu/ops/tcn_train_pallas.py:{line}",
            "launches": launches[counter.__name__],
            "max_abs_err": errs[which],
            "ms": kernel_ms[which][0],
            "plain_ms": kernel_ms[which][1],
            **trunk_bound(TASNET_TRAIN_BATCH, k, which),
            "library_ms": None,
            "max_abs_of_plain": scale[which],
            **({"max_grad_rel_l2": grad_rel, "kernel_launches_per_call": len(bwd_kernels)}
               if which == "backward" else {}),
        }
        for which, counter, line in (("forward", tcn_train_forward, 592),
                                     ("backward", tcn_train_backward, 643))
    ]


CODEC_DIR = pathlib.Path(__file__).resolve().parent / "artifacts" / "t3tok_hard"
CODEC_BATCH, CODEC_TRAIN_BATCH = 64, 8  # bench_tasnet's 64 x 8 s; the committed run's batch_size
# The nearest-code kernel against its plain version (cuBLAS fp32, TF32 off) on
# the same inputs: both fp32, each dot product summed in another order, so a
# pick may differ only at a near tie, where the two codes' float64 squared
# distances are within 1e-5 of ‖x‖² + max ‖e‖² (D <= 64 products each rounded
# at 2^-24 relative, on both sides).
CODE_NEAR_TIE_REL = 1e-5
CODEC_SDR_DB = 0.05  # reconstruction SI-SDR from codes, kernel path against plain path


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()``, back to back: the launches are
    queued behind a ~25 ms sleep kernel, so the host's launch cost (tens of
    microseconds a call, more than these kernels take) is not in the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def si_sdr_db(est, ref) -> float:
    import numpy as np

    est, ref = np.asarray(est, np.float64), np.asarray(ref, np.float64)
    target = (est @ ref) / (ref @ ref) * ref
    return float(10 * np.log10((target @ target) / ((est - target) @ (est - target))))


def near_tie_gaps(flat, codebook, got, want) -> list[float]:
    """float64 |d(x, e_got) − d(x, e_want)| at each row where the picks
    differ; raises where one is not a near tie."""
    import torch

    rows = (got != want).nonzero().flatten()
    x, e = flat[rows].double(), codebook.double()
    d_got = ((x - e[:, got[rows].long()].T) ** 2).sum(1)
    d_want = ((x - e[:, want[rows].long()].T) ** 2).sum(1)
    gaps = (d_got - d_want).abs()
    scale = (x**2).sum(1) + (e**2).sum(0).max()
    bad = (gaps > CODE_NEAR_TIE_REL * scale).nonzero().flatten()
    if len(bad):
        raise AssertionError(f"nearest_code differs from its plain version away from a near tie "
                             f"at rows {rows[bad][:8].tolist()}: gaps {gaps[bad][:8].tolist()}")
    return gaps.tolist() if len(rows) else []


def grouped_near_ties(flat, codebook, got, want) -> list[float]:
    """:func:`near_tie_gaps` of a 2-D call, or of each group of a grouped one."""
    if codebook.dim() == 2:
        return near_tie_gaps(flat, codebook, got, want)
    sub = codebook.shape[1]
    return [gap for g in range(codebook.shape[0]) for gap in near_tie_gaps(
        flat[:, g * sub:(g + 1) * sub], codebook[g], got[:, g], want[:, g])]


def rvq_near_ties(rvq, latent, got, want) -> tuple[int, list[float]]:
    """Mismatched positions of two residual-VQ code streams (stage-major), and
    the near-tie gaps of those whose earlier stages agree; a position whose
    earlier stage already differs follows from that flip."""
    import torch

    pq = rvq.pq
    sub = rvq.embedding_dim // pq
    flat = latent.reshape(-1, rvq.embedding_dim).float()
    got, want = got.reshape(-1, rvq.num_streams), want.reshape(-1, rvq.num_streams)
    residual, mismatches, gaps = flat, 0, []
    for d in range(rvq.depth):
        agree = (got[:, : d * pq] == want[:, : d * pq]).all(1)
        parts = []
        for g in range(pq):
            cb = rvq.embeddings[d, g].detach()
            col = d * pq + g
            mismatches += int((got[:, col] != want[:, col]).sum())
            keep = agree.nonzero().flatten()
            r = residual[keep, g * sub : (g + 1) * sub]
            gaps += near_tie_gaps(r, cb, got[keep, col], want[keep, col])
            parts.append(cb.T[got[:, col].long()])
        residual = residual - torch.cat(parts, 1)
    return mismatches, gaps


def codec_phases(device, gen) -> dict:
    """Phases 15 to 17; returns the nearest-code kernel's entry of the kernels line."""
    import numpy as np
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.audio_io import read_normalized, read_wav
    from speech_separation_tpu_torch.data.datasets import VaeLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.losses import summed_squared_error
    from speech_separation_tpu_torch.models.vqvae import VqVaeT3Tok
    from speech_separation_tpu_torch.ops.tcn_cuda import _device_limits
    from speech_separation_tpu_torch.ops.vq_cuda import nearest_code, nearest_code_plain, search_plan
    from speech_separation_tpu_torch.utils import VaeTrainConfig, load_config
    from speech_separation_tpu_torch.weights import load_params_npz

    # 15. the kernel against its plain version at the main path's shapes: the
    # deep search and one skip group as 2-D calls, a skip stage as one grouped
    # call reading its groups in place from a wider residual, a ragged shape
    # and a codebook past the shared memory (streamed)
    frames = int(BENCH_SECONDS * SAMPLE_RATE) // 40  # 1,600 frames of 40 samples
    shapes = {"deep": (CODEC_BATCH * frames // 8, 1, 64, 512),
              "skip": (CODEC_BATCH * frames // 2, 1, 16, 512),
              "skip stage": (CODEC_BATCH * frames // 2, 4, 16, 512),
              "ragged": (12_803, 3, 13, 509),
              "streamed": (700, 1, 256, 1024)}
    limits = _device_limits(device)
    gaps, mismatches = [], {}
    for label, (n, g, d, k) in shapes.items():
        flat = torch.randn(n, g * d + 8, generator=gen, device=device)[:, 8:]  # row stride g*d + 8
        codebook = torch.randn(g, d, k, generator=gen, device=device)
        if g == 1:
            flat, codebook = flat.contiguous(), codebook[0]
        got, again = nearest_code(flat, codebook), nearest_code(flat, codebook)
        want = nearest_code_plain(flat, codebook)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != torch.int32 or not torch.equal(got, again):
            raise AssertionError(f"nearest_code {label}: {tuple(got.shape)} {got.dtype}, rerun "
                                 f"bit-identical {torch.equal(got, again)}")
        found = grouped_near_ties(flat, codebook, got, want)
        mismatches[label] = len(found)
        gaps += found
        plan = search_plan(n, g, d, k, sms=limits["sms"], smem_optin=limits["smem_optin"],
                           smem_per_sm=limits["smem_per_sm"])
        phase("codec-kernel", f"nearest_code {label} N={n} G={g} S={d} K={k} (row stride "
              f"{flat.stride(0)}; {'resident' if plan.resident else 'streamed'} codebook, "
              f"{plan.ctas} CTAs, {plan.units} units): {len(found)} of {n * g} picks differ "
              f"from the plain version, each a near tie (float64 gaps "
              f"{', '.join(f'{v:.2e}' for v in found[:4]) or 'none'}; bound {CODE_NEAR_TIE_REL} x "
              f"(‖x‖² + max ‖e‖²)); rerun bit-identical")
    # multiples of 1/32 in [-1, 1]: every score is exact in fp32 in any summation
    # order, so duplicated columns tie exactly on both sides
    codebook = (torch.randn(16, 300, generator=gen, device=device) * 8).round().clamp(-32, 32) / 32
    codebook = torch.cat([codebook, codebook, codebook[:, :44]], 1).contiguous()  # 644 codes
    picks = torch.randint(0, 644, (4096,), generator=gen, device=device)
    flat = codebook[:, picks].T.contiguous()  # every row ties exactly between 2 or 3 codes
    got = nearest_code(flat, codebook)
    lowest = torch.where(picks < 300, picks, picks % 300)
    if not (torch.equal(got, lowest.to(torch.int32)) and torch.equal(got, nearest_code_plain(flat, codebook))):
        raise AssertionError("nearest_code: an exact tie did not pick the lowest index")
    phase("codec-kernel", "nearest_code duplicated codebook (644 codes, 4,096 rows each tied "
          "exactly): every pick is the lowest index, as the plain version's")
    # NaN scores: the first NaN's index, as torch.argmin and jnp.argmin pick it,
    # on exact inputs (every finite score exact), resident and streamed, 2-D
    # and grouped: a NaN codebook column at k = 2 (and 7), and rows holding
    # an inf against codes 9 and 40, the only ones holding a 0 in its dimension
    # (inf x 0); the plain version on the CPU and the known pick as expectation
    for form, n, g, d, k in (("2-D", 12_800, 1, 64, 512), ("2-D", 700, 1, 256, 1024),
                             ("grouped", 4_096, 4, 16, 512), ("grouped", 700, 2, 256, 1024)):
        exact = (torch.randn(n, g * d, generator=gen, device=device) * 8).round().clamp(-32, 32) / 32
        book = (torch.randn(g, d, k, generator=gen, device=device) * 8).round().clamp(-32, 32) / 32
        rows = torch.tensor([0, 17, n // 2, n - 1], device=device)
        for case in ("NaN column", "inf row"):
            flat, codebook = exact.clone(), book.clone()
            if case == "NaN column":
                codebook[g - 1, 3, 2] = codebook[g - 1, 0, 7] = float("nan")
                picked, pick = torch.arange(n, device=device), 2
            else:
                flat[rows, (g - 1) * d + 5] = torch.tensor([math.inf, -math.inf] * 2, device=device)
                column = codebook[g - 1, 5]
                column[column == 0] = 1 / 32
                column[[9, 40]] = 0.0
                picked, pick = rows, 9
            if g == 1:
                codebook = codebook[0].contiguous()
            got, again = nearest_code(flat, codebook), nearest_code(flat, codebook)
            want, cpu = nearest_code_plain(flat, codebook), nearest_code_plain(flat.cpu(), codebook.cpu())
            last = (got if g == 1 else got[:, g - 1])[picked]
            if not (torch.equal(got, want) and torch.equal(got.cpu(), cpu) and torch.equal(got, again)
                    and bool((last == pick).all())):
                raise AssertionError(
                    f"nearest_code {case} {form} N={n} G={g} S={d} K={k}: equal to the plain "
                    f"version {torch.equal(got, want)}, to the CPU's {torch.equal(got.cpu(), cpu)}, "
                    f"rerun {torch.equal(got, again)}, picks {last[:4].tolist()} (want {pick})")
        plan = search_plan(n, g, d, k, sms=limits["sms"], smem_optin=limits["smem_optin"],
                           smem_per_sm=limits["smem_per_sm"])
        phase("codec-kernel", f"nearest_code NaN scores {form} N={n} G={g} S={d} K={k} "
              f"({'resident' if plan.resident else 'streamed'}): a NaN column at k = 2 and 7 "
              f"picks 2 on every row, rows holding an inf pick 9 (inf x 0); every pick equal to "
              f"the plain version's on the card and on the CPU, rerun bit-identical")

    # 16. the codec path: the committed trained t3tok through the port's CLI
    cfg = load_config(VaeTrainConfig, CODEC_DIR / "train_config.json")
    model = cli._build_vae_model(cfg, device)
    model.load_state_dict(load_params_npz(CODEC_DIR / "params_ep38.npz"))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 307_880:
        raise AssertionError(f"t3tok has {n_params} params, expected 307,880")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codec_") as tmp:
        tmp = pathlib.Path(tmp)
        ckpt = tmp / "ckpt"
        state = train_mod.TrainState.create(model, train_mod.nadam(), seed=0)
        train_mod.CheckpointManager(ckpt).save_if_best(38, state, 0.0)
        (ckpt / "train_config.json").write_text((CODEC_DIR / "train_config.json").read_text())
        root = make_synthetic_fixture(tmp / "fixture", utterances_per_split={"tr": 8, "cv": 4, "tt": 4},
                                      profile="hard")
        names = (root / "lists" / "tt_wav.lst").read_text().split()
        nearest_code.launches = 0
        t0 = time.perf_counter()
        sdrs, reports = [], []
        for i, name in enumerate(names):
            wav_in = root / "tt" / "s1" / name
            codes, dec, rt = tmp / f"codes_{i}.npz", tmp / f"dec_{i}.wav", tmp / f"rt_{i}.wav"
            for argv in (["codec-encode", "--wav", str(wav_in), "--out", str(codes)],
                         ["codec-decode", "--codes", str(codes), "--out", str(dec)],
                         ["codec-roundtrip", "--wav", str(wav_in), "--out", str(rt)]):
                cli.main([*argv, "--checkpoint-dir", str(ckpt)])
            ref = read_normalized(wav_in, SAMPLE_RATE)
            with np.load(codes) as payload:
                deep, skip = payload["deep"], payload["skip"]
            k = deep.shape[1] * 8
            if deep.dtype != np.int32 or deep.shape != (1, k // 8, 2) or skip.shape != (1, k // 2, 8):
                raise AssertionError(f"{name}: codes {deep.dtype} {deep.shape} {skip.shape}")
            decoded, roundtrip = read_wav(dec)[0], read_wav(rt)[0]
            if len(decoded) != 40 * k or len(roundtrip) != len(ref) or not np.isfinite(decoded).all():
                raise AssertionError(f"{name}: decoded {len(decoded)}, round trip {len(roundtrip)} "
                                     f"samples for {len(ref)}")
            sdrs.append(si_sdr_db(decoded[: len(ref)], ref))
        torch.cuda.synchronize()
        serve_launches, serve_s = nearest_code.launches, time.perf_counter() - t0
        phase("codec-serve", f"cli codec-encode, codec-decode, codec-roundtrip of {len(names)} "
              f"hard-profile utterances (t3tok, params_ep38.npz, {n_params:,} params) in "
              f"{serve_s:.2f} s: reconstruction from codes alone SI-SDR "
              f"{', '.join(f'{v:.2f}' for v in sdrs)} dB (mean {np.mean(sdrs):.2f}); "
              f"nearest_code launches {serve_launches}")

        cfg_path = tmp / "cfg.json"
        cfg_path.write_text(json.dumps({"seed": 0}))
        t0 = time.perf_counter()
        cli.main(["train", "--workload", "vqvae", "--variant", "t3tok", "--config", str(cfg_path),
                  "--data-root", str(root), "--epochs", "2", "--checkpoint-dir", str(tmp / "trained")])
        cli.main(["codec-roundtrip", "--checkpoint-dir", str(tmp / "trained"), "--wav",
                  str(root / "tt" / "s1" / names[0]), "--out", str(tmp / "trained_rt.wav")])
        torch.cuda.synchronize()
        launches = nearest_code.launches
        train_launches = launches - serve_launches
        if serve_launches <= 0 or train_launches <= 0:
            raise AssertionError(f"nearest_code never launched: serving {serve_launches}, training "
                                 f"{train_launches}")
        records = [json.loads(line) for line in (tmp / "trained" / "metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in records if "loss" in r]
        vals = [r["val_loss"] for r in records if "val_loss" in r]
        if len(losses) != 8 or len(vals) != 2 or not all(map(math.isfinite, losses + vals)):
            raise AssertionError(f"cli train vqvae t3tok: step losses {losses}, val losses {vals}")
        if not np.isfinite(read_wav(tmp / "trained_rt.wav")[0]).all():
            raise AssertionError("codec-roundtrip of the trained checkpoint is not finite")
        phase("codec-train", f"cli train --workload vqvae --variant t3tok (JAX defaults: batch 2, "
              f"nadam 1e-3) 2 epochs of tr 8 + cv 4: step losses "
              f"{', '.join(f'{v:.1f}' for v in losses)}; val {', '.join(f'{v:.1f}' for v in vals)}; "
              f"then codec-roundtrip, {time.perf_counter() - t0:.1f} s; nearest_code launches "
              f"{train_launches} (phase total {launches})")

        # the kernel path against the plain path on one batch
        batch = next(iter(VaeLoader(root / "tt", batch_size=4, stacked=True, stride_alignment=8)))
        x = torch.from_numpy(batch.inputs).to(device)
        with torch.inference_mode():
            skip_lat, e3 = model._encode(x)
            kernel_codes = model.codes(x)
            plain_codes = model.codes(x, plain=True)
            recon = {"kernel": model.decode_codes(*kernel_codes),
                     "plain": model.decode_codes(*plain_codes)}
        path_mismatch, path_gaps = 0, []
        for rvq, latent, got, want in ((model.vq1, e3, kernel_codes[0], plain_codes[0]),
                                       (model.vq2, skip_lat, kernel_codes[1], plain_codes[1])):
            m, g = rvq_near_ties(rvq, latent, got, want)
            path_mismatch, path_gaps = path_mismatch + m, path_gaps + g
        diffs = []
        for i, n in enumerate(batch.lengths):
            ref = batch.targets[i, :n, 0]
            s = {kind: si_sdr_db(r[i].reshape(-1)[:n].float().cpu().numpy(), ref) for kind, r in recon.items()}
            diffs.append(s["kernel"] - s["plain"])
            if not abs(diffs[-1]) <= CODEC_SDR_DB:
                raise AssertionError(f"utterance {i}: SI-SDR kernel {s['kernel']} vs plain {s['plain']}")
        total = sum(c.numel() for c in kernel_codes)
        phase("codec-serve", f"one batch {tuple(x.shape)}, kernel path against plain path: "
              f"{path_mismatch} of {total} codes differ ({len(path_gaps)} checked near ties; the "
              f"rest follow an earlier stage's flip); reconstruction SI-SDR differences "
              f"{', '.join(f'{v:+.4f}' for v in diffs)} dB, within {CODEC_SDR_DB}")

        train_batch = next(iter(VaeLoader(root / "tr", batch_size=4, stacked=True, stride_alignment=8)))
    net = VqVaeT3Tok(generator=torch.Generator().manual_seed(0)).to(device)
    state = train_mod.TrainState.create(net, train_mod.nadam(1e-3), seed=0)

    def stacked_loss(preds, targets):
        return summed_squared_error(preds.reshape(preds.shape[0], -1, 1), targets)

    ts, _ = train_mod.make_vae_steps(net, stacked_loss)
    arrays = tuple(torch.from_numpy(a).to(device) for a in (train_batch.inputs, train_batch.targets))
    fixed = [ts(state, *arrays)[1].item() for _ in range(8)]
    if not (all(map(math.isfinite, fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError(f"8 t3tok steps on one batch did not lower the loss: {fixed}")
    phase("codec-train", f"8 steps (nadam 1e-3) on one fixed batch: loss {fixed[0]:.1f} -> "
          f"{fixed[-1]:.1f}")
    del net, state, ts

    # 17. timing: serving at 64 x 8 s, the train step at 8 x 8 s, the kernel alone
    model.eval()
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CODEC_BATCH, frames, 40)).astype(np.float32) * 0.1).to(device)
    audio_s = CODEC_BATCH * BENCH_SECONDS
    with torch.inference_mode():
        codes_k = model.codes(audio)
        paths = {}
        for kind in ("kernel", "plain"):
            plain = kind == "plain"
            paths[f"codes {kind}"] = lambda plain=plain: model.codes(audio, plain=plain)
            paths[f"forward {kind}"] = lambda plain=plain: model(audio, deterministic=True, plain=plain)
        paths["decode_codes"] = lambda: model.decode_codes(*codes_k)
        times = {}
        for order in (list(paths), list(reversed(paths))):
            for what in order:
                times.setdefault(what, []).append(cuda_ms(paths[what], iters=5))
    serve_ms = {}
    for what, vals in times.items():
        serve_ms[what] = min(vals)
        phase("codec-timing", f"t3tok {what}, {CODEC_BATCH} x {BENCH_SECONDS:.0f} s: "
              f"{serve_ms[what]:.2f} ms/batch = {audio_s / (serve_ms[what] / 1e3):,.0f}x real time "
              f"(runs {', '.join(f'{v:.2f}' for v in vals)} ms)")
    train_audio = audio[:CODEC_TRAIN_BATCH]
    targets = train_audio.reshape(CODEC_TRAIN_BATCH, -1, 1)
    step_ms = {}
    for kind in ("plain", "kernel", "kernel", "plain"):
        net = cli._build_vae_model(cfg, device)
        state = train_mod.TrainState.create(net, train_mod.nadam(1e-3), seed=0)
        ts, _ = train_mod.make_vae_steps(net, stacked_loss, plain=kind == "plain")
        step_ms.setdefault(kind, []).append(cuda_ms(lambda: ts(state, train_audio, targets), iters=5))
    for kind, vals in step_ms.items():
        ms = min(vals)
        phase("codec-timing", f"t3tok train step {kind} path, {CODEC_TRAIN_BATCH} x "
              f"{BENCH_SECONDS:.0f} s: {ms:.2f} ms/step = "
              f"{CODEC_TRAIN_BATCH * BENCH_SECONDS / (ms / 1e3):,.0f} audio-s trained per s "
              f"(runs {', '.join(f'{v:.2f}' for v in vals)} ms)")

    # one codes call: its launches of the kernel and their device time
    with torch.inference_mode():
        before = nearest_code.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            model.codes(audio)
            torch.cuda.synchronize()
        codes_launches = nearest_code.launches - before
    searches = [e for e in prof.events()
                if e.device_type.name == "CUDA" and "nearest_code_kernel" in e.name]
    codes_search_ms = sum(e.time_range.elapsed_us() for e in searches) / 1e3
    if codes_launches != 4 or len(searches) != 4:
        raise AssertionError(f"t3tok codes: {codes_launches} nearest_code calls, "
                             f"{len(searches)} kernel launches, expected 4 (2 deep + 2 skip stages)")
    phase("codec-timing", f"t3tok codes, {CODEC_BATCH} x {BENCH_SECONDS:.0f} s: {codes_launches} "
          f"nearest_code launches a call (2 deep stages + 2 skip stages of 4 groups), "
          f"{codes_search_ms * 1e3:.1f} us of kernel device time under the profiler "
          f"({', '.join(f'{e.time_range.elapsed_us():.1f}' for e in searches)} us)")

    kernel_ms, timed_mismatch = {}, 0
    for label in ("deep", "skip", "skip stage"):
        n, g, d, k = shapes[label]
        flat = torch.randn(n, g * d, generator=gen, device=device)
        codebook = torch.randn(g, d, k, generator=gen, device=device)
        if g == 1:
            codebook = codebook[0]
        runs, outs = {"plain": [], "kernel": []}, {}

        def call(kind):
            fn = nearest_code if kind == "kernel" else nearest_code_plain
            outs[kind] = fn(flat, codebook)

        for kind in ("plain", "kernel", "kernel", "plain"):
            runs[kind].append(device_ms(lambda: call(kind), iters=50))
        # the timed calls' own outputs: the kernel's against the plain version's
        # (near ties only) and against an untimed call (bit-identical)
        torch.cuda.synchronize()
        found = grouped_near_ties(flat, codebook, outs["kernel"], outs["plain"])
        if not torch.equal(outs["kernel"], nearest_code(flat, codebook)):
            raise AssertionError(f"nearest_code {label}: the timed output is not bit-identical")
        timed_mismatch += len(found)
        host = cuda_ms(lambda: nearest_code(flat, codebook), iters=50)
        b = bound(4 * (n * g * d + g * d * k + n * g), 2 * n * g * d * k, FP32_FLOPS)
        kernel_ms[label] = (min(runs["kernel"]), min(runs["plain"]), host, b)
        phase("codec-timing", f"nearest_code {label} N={n} G={g} S={d} K={k}: kernel "
              f"{kernel_ms[label][0] * 1e3:.1f} us on the device (bound {b['bound_ms'] * 1e3:.1f} us "
              f"by {b['bound_by']}, {100 * b['bound_ms'] / kernel_ms[label][0]:.1f}%), "
              f"{host * 1e3:.1f} us a call paced by the host, plain {kernel_ms[label][1] * 1e3:.1f} us "
              f"(runs kernel {', '.join(f'{v * 1e3:.1f}' for v in runs['kernel'])}; plain "
              f"{', '.join(f'{v * 1e3:.1f}' for v in runs['plain'])} us); the timed output: "
              f"{len(found)} of {n * g} picks differ from the plain version's, each a near tie, "
              f"rerun bit-identical")

    deep, skip, stage = kernel_ms["deep"], kernel_ms["skip"], kernel_ms["skip stage"]
    return {
        "name": "nearest_code",
        "route": "cuda",
        "source": "speech_separation_tpu_torch/csrc/nearest_code.cu",
        "replaces": "speech_separation_tpu/ops/vq_pallas.py:61",
        "launches": launches,
        "max_abs_err": max(gaps, default=0.0),  # float64 distance gap at a differing pick
        "ms": deep[0],
        "plain_ms": deep[1],
        **deep[3],
        # no single PyTorch call: torch.cdist then argmin is two, with the [N, K]
        # distance matrix in device memory between them
        "library_ms": None,
        "mismatches": mismatches,
        "ms_host_paced": deep[2],
        "ms_skip": skip[0],
        "plain_ms_skip": skip[1],
        "bound_ms_skip": skip[3]["bound_ms"],
        "ms_skip_stage": stage[0],  # one skip stage, 4 groups, one launch
        "plain_ms_skip_stage": stage[1],
        "bound_ms_skip_stage": stage[3]["bound_ms"],
        "launches_per_codes_call": codes_launches,
        "ms_per_codes_call": codes_search_ms,  # the kernel's device time, profiled
        "timed_mismatches": timed_mismatch,
        "launches_serving": serve_launches,
        "launches_training": train_launches,
    }


def max_err(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def bf16_bound(want) -> float:
    return TRAIN_BF16_TOL * max(1.0, max(w.float().abs().max().item() for w in want))


def training_phases(device, model, gen, kept) -> tuple[list[dict], dict]:
    """Phases 6 to 8; returns the two training kernels' entries of the kernels
    line and phase 8's kernel-path audio-s trained per s by dtype."""
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.models import blstm as blstm_module
    from speech_separation_tpu_torch.models import upit as upit_module
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.ops.lstm_cuda import lstm_recurrence
    from speech_separation_tpu_torch.ops.lstm_train_cuda import (
        bilstm_reference,
        bilstm_train,
        lstm_train_backward,
        lstm_train_backward_plain,
        lstm_train_forward,
        lstm_train_forward_plain,
    )
    from speech_separation_tpu_torch.ops.stft import stft_frame_count
    from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda

    # 6. training kernels against their plain versions at full width
    hidden, batch, steps = 496, 16, 501
    u = model.bilstm_1.cells.recurrent_kernel.detach()
    xw = torch.randn(2, batch, steps, 4 * hidden, generator=gen, device=device)
    dy = torch.randn(batch, steps, 2 * hidden, generator=gen, device=device)
    # segment breaks every ~40 steps, in each direction's scan order
    keep = (torch.rand(2, batch, steps, generator=gen, device=device) > 0.025).float()
    errs = {}
    with torch.no_grad():
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            for kname, k in (("", None), ("+keep", keep)):
                want = lstm_train_forward_plain(xw, u, keep=k, compute_dtype=dt)
                got = lstm_train_forward(xw, u, keep=k, compute_dtype=dt)
                fwd_again = lstm_train_forward(xw, u, keep=k, compute_dtype=dt)
                fwd_same = all(torch.equal(a, b) for a, b in zip(got, fwd_again))
                fwd_err, fwd_bound = max_err(got, want), TRAIN_TOL
                _, gates, c_all = want
                want_dg = lstm_train_backward_plain(gates, c_all, dy.to(dt), u, keep=k,
                                                    compute_dtype=dt)
                got_dg = lstm_train_backward(gates, c_all, dy.to(dt), u, keep=k, compute_dtype=dt)
                again = lstm_train_backward(gates, c_all, dy.to(dt), u, keep=k, compute_dtype=dt)
                bwd_err, bwd_bound = max_err([got_dg], [want_dg]), TRAIN_TOL
                if dt == torch.bfloat16:
                    fwd_bound, bwd_bound = bf16_bound(want), bf16_bound([want_dg])
                torch.cuda.synchronize()
                if not (fwd_err <= fwd_bound and bwd_err <= bwd_bound and torch.equal(got_dg, again)
                        and fwd_same):
                    raise AssertionError(
                        f"training kernels {tag}{kname}: forward max abs err {fwd_err} "
                        f"(bound {fwd_bound}), backward {bwd_err} (bound {bwd_bound}), reruns "
                        f"bit-identical: forward {fwd_same}, backward {torch.equal(got_dg, again)}"
                    )
                errs[tag + kname] = (fwd_err, bwd_err)
                phase("train-kernels", f"{tag}{kname} H={hidden} B={batch} T={steps} D=2: "
                      f"forward (h, gates, c) max abs err {fwd_err:.3e} <= {fwd_bound:.3e}; "
                      f"backward dgates {bwd_err:.3e} <= {bwd_bound:.3e} "
                      f"(max |dgates| {want_dg.float().abs().max().item():.3f}), reruns of both "
                      f"bit-identical")
        # B = 64: four groups of 16 rows, two to a block (124 blocks, one an SM)
        xw64 = torch.randn(2, 64, steps, 4 * hidden, generator=gen, device=device)
        dy64 = torch.randn(64, steps, 2 * hidden, generator=gen, device=device)
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            _, gates, c_all = lstm_train_forward_plain(xw64, u, compute_dtype=dt)
            before = lstm_train_backward.launches
            got_dg = lstm_train_backward(gates, c_all, dy64.to(dt), u, compute_dtype=dt)
            again = lstm_train_backward(gates, c_all, dy64.to(dt), u, compute_dtype=dt)
            want_dg = lstm_train_backward_plain(gates, c_all, dy64.to(dt), u, compute_dtype=dt)
            torch.cuda.synchronize()
            err = max_err([got_dg], [want_dg])
            lim = TRAIN_TOL if dt == torch.float32 else bf16_bound([want_dg])
            launched = lstm_train_backward.launches - before
            if not (err <= lim and torch.equal(got_dg, again) and launched == 2):
                raise AssertionError(f"lstm_train_backward B=64 {tag}: max abs err {err} (bound "
                                     f"{lim}), rerun bit-identical {torch.equal(got_dg, again)}, "
                                     f"{launched} launches for 2 calls")
            phase("train-kernels", f"lstm_train_backward {tag} H={hidden} B=64 T={steps} D=2: dgates "
                  f"max abs err {err:.3e} <= {lim:.3e}, rerun bit-identical, one launch a call")
        # the forward at B = 32 (the training bench's shape: one group a block,
        # two row blocks), B = 64 (two groups a block) and B = 256 (eight)
        for b in (32, 64, 256):
            xwb = xw64 if b == 64 else torch.randn(2, b, steps, 4 * hidden, generator=gen,
                                                   device=device)
            for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                want = lstm_train_forward_plain(xwb, u, compute_dtype=dt)
                before = lstm_train_forward.launches
                got = lstm_train_forward(xwb, u, compute_dtype=dt)
                again = lstm_train_forward(xwb, u, compute_dtype=dt)
                torch.cuda.synchronize()
                err, launched = max_err(got, want), lstm_train_forward.launches - before
                lim = TRAIN_TOL if dt == torch.float32 else bf16_bound(want)
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                if not (err <= lim and same and launched == 2):
                    raise AssertionError(f"lstm_train_forward B={b} {tag}: max abs err {err} "
                                         f"(bound {lim}), rerun bit-identical {same}, {launched} "
                                         f"launches for 2 calls")
                phase("train-kernels", f"lstm_train_forward {tag} H={hidden} B={b} T={steps} D=2: "
                      f"(h, gates, c) max abs err {err:.3e} <= {lim:.3e}, rerun bit-identical, "
                      f"one launch a call")
            del xwb, want, got, again
        del xw64, dy64

    cells = model.bilstm_1.cells
    x = 0.5 * torch.randn(batch, steps, 2 * hidden, generator=gen, device=device)
    w = torch.randn(batch, steps, 2 * hidden, generator=gen, device=device)
    for kname, k in (("", None), ("+keep", keep)):
        grads = []
        for run in (lambda *a: bilstm_train(*a, keep=k, compute_dtype=torch.float32),
                    lambda *a: bilstm_reference(*a, keep=k)):
            params = [t.detach().clone().requires_grad_()
                      for t in (x, cells.kernel, cells.recurrent_kernel, cells.bias)]
            (run(*params) * w).sum().backward()
            grads.append([p.grad for p in params])
        rels = [((a - b).norm() / b.norm()).item() for a, b in zip(*grads)]
        if not max(rels) <= GRAD_REL_TOL:
            raise AssertionError(f"bilstm_train{kname} gradients against autograd: rel L2 {rels}")
        phase("train-kernels", f"bilstm_train{kname} fp32 B={batch} T={steps} F={2 * hidden}: "
              f"dx, dkernel, drecurrent, dbias rel L2 against autograd through the plain loop "
              f"{', '.join(f'{r:.2e}' for r in rels)} <= {GRAD_REL_TOL}")

    # 7. training path through the port's CLI at full width
    counters = (stft_cuda, lstm_recurrence, lstm_train_forward, lstm_train_backward)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = pathlib.Path(tmp)
        root = make_synthetic_fixture(tmp / "fixture",
                                      utterances_per_split={"tr": 8, "cv": 4, "tt": 4})
        for counter in counters:
            counter.launches = 0
        t0 = time.perf_counter()
        with (counting_calls(upit_module, "bilstm_train") as fwd_calls,
              counting_calls(blstm_module, "lstm_recurrence") as serve_calls):
            for tag, bf16 in (("fp32", False), ("bf16", True)):
                cfg = tmp / f"cfg_{tag}.json"
                cfg.write_text(json.dumps({"seed": 0, "batch_size": 4, "bf16_compute": bf16}))
                ckpt = tmp / f"ckpt_{tag}"
                cli.main(["train", "--workload", "upit", "--config", str(cfg), "--data-root",
                          str(root), "--epochs", "2", "--checkpoint-dir", str(ckpt)])
                records = [json.loads(line)
                           for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
                losses = [r["loss"] for r in records if "loss" in r]
                vals = [r["val_loss"] for r in records if "val_loss" in r]
                if len(losses) != 4 or len(vals) != 2 or not all(map(math.isfinite, losses + vals)):
                    raise AssertionError(f"cli train {tag}: step losses {losses}, "
                                         f"val losses {vals}")
                if not list(ckpt.glob("ckpt_*.pt")) or not (ckpt / "train_config.json").exists():
                    raise AssertionError(f"cli train {tag}: no checkpoint in "
                                         f"{sorted(ckpt.iterdir())}")
                phase("train", f"cli train {tag} (UPitBlstm at the config's full width), 2 epochs "
                      f"of tr 8 (batch 4) + cv 4: step losses "
                      f"{', '.join(f'{v:.2f}' for v in losses)}; "
                      f"val {', '.join(f'{v:.2f}' for v in vals)}")
            out = tmp / "sep"
            cli.main(["separate", "--checkpoint-dir", str(tmp / "ckpt_bf16"), "--data-root",
                      str(root), "--out-dir", str(out)])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if min(launches.values()) <= 0:
            raise AssertionError(f"a kernel of the training path never launched: {launches}")
        # batches of at most 4 are one row slice each: one launch a call (a
        # bilstm_train call is one lstm_train_forward call)
        for name, calls in (("lstm_train_forward", fwd_calls), ("lstm_recurrence", serve_calls)):
            if launches[name] != calls[0]:
                raise AssertionError(f"{name}: {launches[name]} launches for {calls[0]} calls "
                                     f"of one row slice each")
        wavs = sorted(out.glob("*.wav"))
        if len(wavs) != 8:
            raise AssertionError(f"cli separate wrote {len(wavs)} wavs for 4 mixtures")
        phase("train", f"cli train fp32 + bf16 and cli separate --checkpoint-dir (8 wavs) in "
              f"{seconds:.1f} s; launches {launches}; the forward kernels one a call "
              f"({fwd_calls[0]} training, {serve_calls[0]} serving calls)")
        keep_output(kept, "phase 7 BLSTM cli train bf16 + separate", root, out)

        # the kernel path's train step against the plain path's, on one batch
        loader = WaveformLoader(root / "tr", batch_size=4)
        b = next(iter(loader))
        arrays = tuple(torch.from_numpy(a).to(device) for a in (b.mix, b.sources, b.frame_lengths))
        step_losses = {}
        for kind in ("kernel", "plain"):
            net = UPitBlstm(dropout_rate=0.0, generator=torch.Generator().manual_seed(0)).to(device)
            state = train_mod.TrainState.create(net, train_mod.exponential_decay_adam(), seed=0)
            ts, ev = train_mod.make_upit_waveform_steps(net, plain=kind == "plain")
            step_losses[kind] = [ts(state, *arrays)[1].item() for _ in range(2)]
            step_losses[kind].append(ev(state, *arrays).item())
        rel = max(abs(a - c) / abs(c) for a, c in zip(step_losses["kernel"], step_losses["plain"]))
        if not rel <= STEP_REL_TOL:
            raise AssertionError(f"train steps kernel vs plain: {step_losses} (rel {rel})")
        phase("train", f"fp32 kernel path against plain path, 2 train steps + eval on one batch "
              f"{tuple(b.mix.shape)}: losses {step_losses['kernel']} vs {step_losses['plain']}, "
              f"max rel {rel:.2e} <= {STEP_REL_TOL}")

        for tag, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            net = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device)
            state = train_mod.TrainState.create(net, train_mod.exponential_decay_adam(), seed=0)
            ts, _ = train_mod.make_upit_waveform_steps(net, compute_dtype=dt)
            fixed = [ts(state, *arrays)[1].item() for _ in range(8)]
            if not (all(map(math.isfinite, fixed)) and fixed[-1] < fixed[0]):
                raise AssertionError(f"8 steps {tag} on one batch did not lower the loss: {fixed}")
            phase("train", f"8 steps {tag} exponential_decay_adam on one fixed batch: loss "
                  f"{fixed[0]:.2f} -> {fixed[-1]:.2f}")

    # 8. training timing at bench_blstm_train's shape
    samples = int(BENCH_SECONDS * SAMPLE_RATE)
    frames = stft_frame_count(samples, 256, 128)
    sources = 0.1 * torch.randn(TRAIN_BATCH, 2, samples, generator=gen, device=device)
    arrays = (sources.sum(1), sources,
              torch.full((TRAIN_BATCH,), frames, dtype=torch.int32, device=device))
    audio_s = TRAIN_BATCH * BENCH_SECONDS
    step_ms = {}
    for tag, dt in (("fp32", None), ("bf16", torch.bfloat16)):
        for kind in ("plain", "kernel", "kernel", "plain"):
            net = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device)
            state = train_mod.TrainState.create(net, train_mod.exponential_decay_adam(), seed=0)
            ts, _ = train_mod.make_upit_waveform_steps(net, compute_dtype=dt,
                                                      plain=kind == "plain")
            step_ms.setdefault((tag, kind), []).append(
                cuda_ms(lambda: ts(state, *arrays), iters=3))
    for (tag, kind), vals in step_ms.items():
        ms = min(vals)
        phase("train-timing", f"train step {tag} {kind} path, {TRAIN_BATCH} x "
              f"{BENCH_SECONDS:.0f} s: {ms:.1f} ms/step = {audio_s / (ms / 1e3):,.1f} "
              f"audio-s trained per s (runs {', '.join(f'{v:.1f}' for v in vals)} ms)")
    bucketed = {tag: audio_s / (min(step_ms[(tag, "kernel")]) / 1e3) for tag in ("fp32", "bf16")}

    xw = torch.randn(2, TRAIN_BATCH, frames, 4 * hidden, generator=gen, device=device)
    dy = torch.randn(TRAIN_BATCH, frames, 2 * hidden, generator=gen, device=device)
    kernel_ms = {}
    with torch.no_grad():
        for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x_t, u_t, dy_t = xw.to(dt), u.to(dt), dy.to(dt)
            _, gates, c_all = lstm_train_forward(x_t, u_t)
            kernel_ms[tag] = {
                "forward": (cuda_ms(lambda: lstm_train_forward(x_t, u_t), iters=5),
                            cuda_ms(lambda: lstm_train_forward_plain(x_t, u_t), iters=2)),
                "backward": (cuda_ms(lambda: lstm_train_backward(gates, c_all, dy_t, u_t), iters=5),
                             cuda_ms(lambda: lstm_train_backward_plain(gates, c_all, dy_t, u_t),
                                     iters=2)),
            }
            for which, (k_ms, p_ms) in kernel_ms[tag].items():
                phase("train-timing", f"lstm_train_{which} {tag} D=2 B={TRAIN_BATCH} T={frames} "
                      f"H={hidden}: kernel {k_ms:.2f} ms ({1e3 * k_ms / frames:.2f} us a step), "
                      f"plain {p_ms:.2f} ms")
            # the timed forward's outputs against its plain version at this
            # shape (one group a block over two row blocks), rerun bit-identical
            got = lstm_train_forward(x_t, u_t)
            again = lstm_train_forward(x_t, u_t)
            want = lstm_train_forward_plain(x_t, u_t)
            torch.cuda.synchronize()
            err = max_err(got, want)
            lim = TRAIN_TOL if dt == torch.float32 else bf16_bound(want)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if not (err <= lim and same):
                raise AssertionError(f"timed lstm_train_forward {tag} B={TRAIN_BATCH}: max abs err "
                                     f"{err} (bound {lim}), rerun bit-identical {same}")
            phase("train-timing", f"the timed lstm_train_forward {tag} B={TRAIN_BATCH} T={frames} "
                  f"H={hidden} against its plain version: (h, gates, c) max abs err {err:.3e} <= "
                  f"{lim:.3e}, rerun bit-identical")
            del got, again, want
            phase("train-timing", f"lstm_train_forward {tag}: "
                  f"{1e3 * kernel_ms[tag]['forward'][0] / frames:.2f} us a step, "
                  f"lstm_train_backward {1e3 * kernel_ms[tag]['backward'][0] / frames:.2f} us a "
                  f"step, each in one "
                  f"persistent launch; train step {tag} kernel path "
                  f"{min(step_ms[(tag, 'kernel')]):.1f} ms")

    # cuDNN's bidirectional layer in training mode at the same shape, fp32: its
    # forward (keeping what its backward needs) and its backward; both also
    # cover the input projection, which the kernels' callers leave to cuBLAS.
    # The same work on the port's side is bilstm_train's whole forward (the
    # projection and the kernel, keeping the residuals) and its whole backward
    # (the kernel plus the dx, dkernel, drecurrent and dbias products); each
    # pair alternates, and each keeps its best of two captures.
    cudnn = torch.nn.LSTM(2 * hidden, hidden, batch_first=True, bidirectional=True).to(device)
    x_in = torch.randn(TRAIN_BATCH, frames, 2 * hidden, generator=gen, device=device,
                       requires_grad=True)
    layer = [t.detach().clone().requires_grad_()
             for t in (x_in, cells.kernel, cells.recurrent_kernel, cells.bias)]
    forward_ms = {}
    for which in ("cudnn", "port", "port", "cudnn"):
        fn = ((lambda: cudnn(x_in)) if which == "cudnn"
              else (lambda: bilstm_train(*layer, compute_dtype=torch.float32)))
        forward_ms.setdefault(which, []).append(cuda_ms(fn, iters=5))
    lib_fwd_ms, layer_fwd_ms = min(forward_ms["cudnn"]), min(forward_ms["port"])
    y_out = cudnn(x_in)[0]
    dy_out = torch.randn_like(y_out)
    y_layer = bilstm_train(*layer, compute_dtype=torch.float32)
    backward_ms = {}
    for which in ("cudnn", "port", "port", "cudnn"):
        y, g = (y_out, dy_out) if which == "cudnn" else (y_layer, dy_out)
        backward_ms.setdefault(which, []).append(
            cuda_ms(lambda: torch.autograd.backward(y, g, retain_graph=True), iters=5))
    lib_bwd_ms, layer_bwd_ms = min(backward_ms["cudnn"]), min(backward_ms["port"])
    del cudnn, x_in, y_out, dy_out, layer, y_layer
    phase("train-timing", f"cuDNN nn.LSTM fp32 bidirectional training B={TRAIN_BATCH} T={frames} "
          f"H={hidden} (input 2H, projection included): forward {lib_fwd_ms:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in forward_ms['cudnn'])}); bilstm_train's whole forward, "
          f"the same work (cuBLAS projection + lstm_train_forward): {layer_fwd_ms:.2f} ms (runs "
          f"{', '.join(f'{v:.2f}' for v in forward_ms['port'])}); backward "
          f"{lib_bwd_ms:.2f} ms (runs {', '.join(f'{v:.2f}' for v in backward_ms['cudnn'])}); "
          f"bilstm_train's whole backward, the same work (lstm_train_backward + dx, dkernel, "
          f"drecurrent, dbias in cuBLAS): {layer_bwd_ms:.2f} ms "
          f"(runs {', '.join(f'{v:.2f}' for v in backward_ms['port'])})")
    d, h4 = 2, 4 * hidden
    gates_bytes = 4 * d * TRAIN_BATCH * frames * h4
    c_bytes = 4 * d * TRAIN_BATCH * frames * hidden
    u_bytes = 4 * d * hidden * h4
    flops = 2 * d * TRAIN_BATCH * frames * hidden * h4
    bounds = {  # xw, U in; h, gates, c out / gates, c, dy, U in; dgates out
        "forward": bound(gates_bytes + u_bytes + c_bytes + gates_bytes + c_bytes, flops, FP32_FLOPS),
        "backward": bound(gates_bytes + c_bytes + c_bytes + u_bytes + gates_bytes, flops,
                          FP32_FLOPS),
    }
    library = {"forward": lib_fwd_ms, "backward": lib_bwd_ms}

    entries = []
    for which, counter, line in (("forward", lstm_train_forward, 169),
                                 ("backward", lstm_train_backward, 211)):
        i = 0 if which == "forward" else 1
        entries.append({
            "name": f"lstm_train_{which}",
            "route": "cuda",
            "source": "speech_separation_tpu_torch/csrc/"
                      + ("lstm_recurrence.cu" if which == "forward" else "lstm_train_backward.cu"),
            "replaces": f"speech_separation_tpu/ops/lstm_train_pallas.py:{line}",
            "launches": launches[counter.__name__],
            "max_abs_err": errs["fp32"][i],
            "ms": kernel_ms["fp32"][which][0],
            "plain_ms": kernel_ms["fp32"][which][1],
            **bounds[which],
            "library_ms": library[which],
            "max_abs_err_keep": errs["fp32+keep"][i],
            "max_abs_err_bf16": errs["bf16"][i],
            "max_abs_err_bf16_keep": errs["bf16+keep"][i],
            "ms_bf16": kernel_ms["bf16"][which][0],
            "plain_ms_bf16": kernel_ms["bf16"][which][1],
            "us_per_step": 1e3 * kernel_ms["fp32"][which][0] / frames,
            "us_per_step_bf16": 1e3 * kernel_ms["bf16"][which][0] / frames,
            # library_ms (cuDNN's forward and backward) also computes the input
            # projection, and the backward dx and the weight gradients: the
            # port's side of that work is its whole layer forward or backward
            f"layer_{which}_ms": layer_fwd_ms if which == "forward" else layer_bwd_ms,
        })
    return entries, bucketed


def packed_phases(device, kept, bucketed) -> dict:
    """Phases 18 and 19; returns the packed path's launches of rows 3 and 4
    (``lstm_train_forward``, ``lstm_train_backward``) for the kernels line."""
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.data.packing import PackedWaveformLoader
    from speech_separation_tpu_torch.losses.pit import pit_loss_packed
    from speech_separation_tpu_torch.models import upit as upit_module
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.ops import lstm_train_cuda
    from speech_separation_tpu_torch.ops.features import psm_features
    from speech_separation_tpu_torch.ops.lstm_cuda import lstm_recurrence
    from speech_separation_tpu_torch.ops.lstm_train_cuda import lstm_train_backward, lstm_train_forward
    from speech_separation_tpu_torch.ops.stft_cuda import stft_cuda

    # 18. packed training through the port's CLI at full width
    counters = (stft_cuda, lstm_recurrence, lstm_train_forward, lstm_train_backward)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_packed_") as tmp:
        tmp = pathlib.Path(tmp)
        root = make_synthetic_fixture(tmp / "fixture",
                                      utterances_per_split={"tr": 24, "cv": 8, "tt": 8})
        for counter in counters:
            counter.launches = 0
        lstm_train_forward.keep_launches = lstm_train_backward.keep_launches = 0
        steps, t0 = 0, time.perf_counter()
        with (counting_calls(upit_module, "bilstm_train") as calls,
              counting_calls(lstm_train_cuda, "lstm_train_forward_plain") as fwd_plain,
              counting_calls(lstm_train_cuda, "lstm_train_backward_plain") as bwd_plain):
            for tag, bf16 in (("fp32", False), ("bf16", True)):
                cfg, ckpt = tmp / f"cfg_{tag}.json", tmp / f"ckpt_{tag}"
                cfg.write_text(json.dumps({"seed": 0, "pack": True, "pack_rows_per_batch": 2,
                                           "pack_row_seconds": PACK_ROW_SECONDS,
                                           "bf16_compute": bf16}))
                cli.main(["train", "--workload", "upit", "--config", str(cfg), "--data-root",
                          str(root), "--epochs", "2", "--checkpoint-dir", str(ckpt)])
                records = [json.loads(line) for line in (ckpt / "metrics.jsonl").read_text().splitlines()]
                losses = [r["loss"] for r in records if "loss" in r]
                vals = [r["val_loss"] for r in records if "val_loss" in r]
                if not (losses and len(vals) == 2 and all(map(math.isfinite, losses + vals))):
                    raise AssertionError(f"cli train pack {tag}: step losses {losses}, val {vals}")
                steps += len(losses)
                phase("packed-train", f"cli train pack=true {tag} (UPitBlstm 16,077,602 params), 2 "
                      f"epochs of tr 24 in rows of {PACK_ROW_SECONDS:.0f} s, 2 a batch, + cv 8: "
                      f"step losses {', '.join(f'{v:.2f}' for v in losses)}; val "
                      f"{', '.join(f'{v:.2f}' for v in vals)}")
            out = tmp / "sep"
            cli.main(["separate", "--checkpoint-dir", str(tmp / "ckpt_fp32"), "--data-root",
                      str(root), "--out-dir", str(out)])
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        keep = {c.__name__: c.keep_launches for c in (lstm_train_forward, lstm_train_backward)}
        # every training forward a keep-mode launch (rows <= 256: one row slice),
        # 3 keep-mode backward launches a train step, no launch without the gate
        # and no plain loop
        if not (min(launches.values()) > 0 and keep["lstm_train_forward"] == calls[0]
                == launches["lstm_train_forward"] and keep["lstm_train_backward"] == 3 * steps
                == launches["lstm_train_backward"] and fwd_plain[0] == bwd_plain[0] == 0):
            raise AssertionError(f"packed path: launches {launches}, keep-mode {keep}, "
                                 f"{calls[0]} bilstm_train calls, {steps} train steps, plain "
                                 f"loops {fwd_plain[0]} + {bwd_plain[0]}")
        if len(list(out.glob("*.wav"))) != 16:
            raise AssertionError(f"cli separate wrote {len(list(out.glob('*.wav')))} wavs for 8")
        phase("packed-train", f"cli train pack=true fp32 + bf16 ({steps} steps) and cli separate "
              f"--checkpoint-dir (16 wavs) in {seconds:.1f} s; launches {launches}; keep-mode "
              f"{keep} ({calls[0]} bilstm_train calls: 3 forward and 3 backward a step); no plain "
              f"loop")
        keep_output(kept, "phase 18 packed BLSTM cli train fp32 + separate", root, out)

        loader = PackedWaveformLoader(root / "tr", rows_per_batch=2, row_seconds=PACK_ROW_SECONDS)
        b = next(iter(loader))
        mix, sources, seg = (torch.from_numpy(a).to(device) for a in (b.mix, b.sources, b.frame_seg))
        # each utterance alone and unpadded (its backward direction starts at
        # its own last frame, as in its segment)
        singles = {n: one for one in WaveformLoader(root / "tr", batch_size=1, pad_quantum_samples=1)
                   for n in one.names if any(n in row for row in b.names)}

    def net(dropout=0.0):
        return UPitBlstm(dropout_rate=dropout, generator=torch.Generator().manual_seed(0)).to(device)

    groups = {"input projection": ("input_proj.",), "input kernels and biases": (".cells.kernel",
              ".cells.bias"), "recurrent kernels": (".recurrent_kernel",), "mask heads": ("heads.",)}

    def loss_and_grads(plain):
        model = net()
        feats = psm_features(mix, sources, plain=plain)
        preds = model.train_forward(feats.magnitude, segment_ids=seg, plain=plain)
        loss = pit_loss_packed(preds, feats.labels, seg, num_segments=loader.num_segments)
        loss.backward()
        grads = {g: torch.cat([p.grad.flatten() for n, p in model.named_parameters()
                               if any(k in n for k in keys)]) for g, keys in groups.items()}
        return loss.item(), grads

    before = (lstm_train_forward.keep_launches, lstm_train_backward.keep_launches)
    k_loss, k_grads = loss_and_grads(False)
    launched = (lstm_train_forward.keep_launches - before[0], lstm_train_backward.keep_launches - before[1])
    p_loss, p_grads = loss_and_grads(True)
    rel = abs(k_loss - p_loss) / abs(p_loss)
    rels = {g: ((k_grads[g] - p_grads[g]).norm() / p_grads[g].norm()).item() for g in groups}
    if not (rel <= STEP_REL_TOL and max(rels.values()) <= GRAD_REL_TOL and launched == (3, 3)):
        raise AssertionError(f"packed batch kernel vs plain: loss {k_loss} vs {p_loss} (rel {rel}), "
                             f"gradients {rels}, keep-mode launches {launched}")
    occupancy = float((b.frame_seg >= 0).mean())
    phase("packed-train", f"one packed batch {tuple(b.mix.shape)} ({sum(map(len, b.names))} "
          f"utterances, occupancy {occupancy:.3f}), fp32 kernel path (3 + 3 keep-mode launches) "
          f"against plain path: loss {k_loss:.4f} vs {p_loss:.4f} (rel {rel:.1e} <= {STEP_REL_TOL}); "
          f"gradients rel L2 " + ", ".join(f"{g} {v:.1e}" for g, v in rels.items())
          + f" <= {GRAD_REL_TOL}")

    # the packed loss is the sum of each utterance's loss run alone; the
    # serving forward with segment_ids runs the training kernel's keep mode
    model = net()
    state = train_mod.TrainState.create(model, train_mod.exponential_decay_adam(), seed=0)
    _, eval_packed = train_mod.make_upit_packed_steps(model, num_segments=loader.num_segments)
    _, eval_single = train_mod.make_upit_waveform_steps(model)
    alone = sum(eval_single(state, *(torch.from_numpy(a).to(device) for a in (
        one.mix, one.sources, one.frame_lengths))).item() for one in singles.values())
    packed_loss = eval_packed(state, mix, sources, seg).item()
    sum_rel = abs(packed_loss - alone) / abs(alone)
    with torch.no_grad():
        feats = psm_features(mix, sources)
        before = lstm_train_forward.keep_launches
        served = model(feats.magnitude, segment_ids=seg)
        served_launches = lstm_train_forward.keep_launches - before
        trained = model.train_forward(feats.magnitude, segment_ids=seg)
        plain = model(feats.magnitude, segment_ids=seg, plain=True)
    serve_rel = max(((served - w).norm() / w.norm()).item() for w in (trained, plain))
    if not (sum_rel <= PACKED_SUM_REL and served_launches == 3 and serve_rel <= PATH_REL_TOL):
        raise AssertionError(f"packed loss {packed_loss} vs the utterances alone {alone} (rel "
                             f"{sum_rel}); forward(segment_ids): {served_launches} keep-mode "
                             f"launches, rel L2 {serve_rel} against train_forward and plain")
    phase("packed-train", f"fp32 kernel path: packed loss {packed_loss:.4f} = the sum over its "
          f"{len(singles)} utterances run alone {alone:.4f} (rel {sum_rel:.1e} <= {PACKED_SUM_REL}); "
          f"forward(segment_ids) under no_grad: 3 keep-mode training-forward launches, rel L2 "
          f"{serve_rel:.1e} <= {PATH_REL_TOL} against train_forward and the plain path")

    model = net(dropout=0.8)
    state = train_mod.TrainState.create(model, train_mod.exponential_decay_adam(), seed=0)
    ts, _ = train_mod.make_upit_packed_steps(model, num_segments=loader.num_segments)
    fixed = [ts(state, mix, sources, seg)[1].item() for _ in range(8)]
    if not (all(map(math.isfinite, fixed)) and fixed[-1] < fixed[0]):
        raise AssertionError(f"8 packed steps on one batch did not lower the loss: {fixed}")
    phase("packed-train", f"8 packed steps fp32 exponential_decay_adam on one fixed batch: loss "
          f"{fixed[0]:.2f} -> {fixed[-1]:.2f}")

    # 19. packed training timing at the JAX loader's defaults
    with tempfile.TemporaryDirectory(prefix="chip_smoke_packed_timing_") as tmp:
        root = make_synthetic_fixture(pathlib.Path(tmp) / "fixture",
                                      utterances_per_split={"tr": 96, "cv": 1, "tt": 1})
        loader = PackedWaveformLoader(root / "tr", rows_per_batch=PACK_ROWS, row_seconds=PACK_ROW_SECONDS)
        b = next(iter(loader))
    if b.mix.shape[0] != PACK_ROWS or b.frame_seg.shape[1] != 1001:
        raise AssertionError(f"packed timing batch {b.mix.shape}, frames {b.frame_seg.shape}")
    arrays = tuple(torch.from_numpy(a).to(device) for a in (b.mix, b.sources, b.frame_seg))
    occupancy = float((b.frame_seg >= 0).mean())
    step_ms = {}
    for tag, dt, kinds in (("fp32", None, ("plain", "kernel", "kernel", "plain")),
                           ("bf16", torch.bfloat16, ("kernel", "kernel"))):
        for kind in kinds:
            model = net(dropout=0.8)
            state = train_mod.TrainState.create(model, train_mod.exponential_decay_adam(), seed=0)
            ts, _ = train_mod.make_upit_packed_steps(model, num_segments=loader.num_segments,
                                                     compute_dtype=dt, plain=kind == "plain")
            step_ms.setdefault((tag, kind), []).append(
                cuda_ms(lambda: ts(state, *arrays), iters=3 if kind == "kernel" else 2))
    rates = {}
    for (tag, kind), vals in step_ms.items():
        ms = min(vals)
        rates[(tag, kind)] = b.audio_seconds / (ms / 1e3)
        extra = f"; bucketed 32 x 8 s (phase 8): {bucketed[tag]:,.1f}" if kind == "kernel" else ""
        phase("packed-timing", f"packed train step {tag} {kind} path, {PACK_ROWS} rows x "
              f"{PACK_ROW_SECONDS:.0f} s (1,001 frames, {sum(map(len, b.names))} utterances, "
              f"{b.audio_seconds:.2f} s of true audio, frame occupancy {occupancy:.4f}): {ms:.1f} "
              f"ms/step = {rates[(tag, kind)]:,.1f} audio-s trained per s (runs "
              f"{', '.join(f'{v:.1f}' for v in vals)} ms){extra}")
    return {
        name: {"keep_launches_packed": keep[name],
               "packed_step_ms": min(step_ms[("fp32", "kernel")]),
               "packed_step_ms_bf16": min(step_ms[("bf16", "kernel")]),
               "packed_audio_s_per_s": rates[("fp32", "kernel")],
               "packed_audio_s_per_s_bf16": rates[("bf16", "kernel")]}
        for name in ("lstm_train_forward", "lstm_train_backward")
    }


def scoring_phases(device, kept) -> None:
    """Phase 20: ``cli evaluate`` on every kept path's output, then the
    overfit quality run."""
    import torch

    from speech_separation_tpu_torch import cli
    from speech_separation_tpu_torch import train as train_mod
    from speech_separation_tpu_torch.data.datasets import WaveformLoader
    from speech_separation_tpu_torch.data.fixture import make_synthetic_fixture
    from speech_separation_tpu_torch.evaluate import evaluate_directory
    from speech_separation_tpu_torch.models.upit import UPitBlstm
    from speech_separation_tpu_torch.separate.pipeline import separate_directory

    fields = ("si_sdr", "si_sdri", "sdr", "isr", "sir", "sar")
    for path in sorted(kept.iterdir(), key=lambda p: int(p.name.split()[1])):
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            cli.main(["evaluate", "--data-root", str(path / "data"), "--est-dir", str(path / "est")])
        line = json.loads(printed.getvalue().strip().splitlines()[-1])
        _, agg = evaluate_directory(path / "data", path / "est")
        same = all(line[f"{k}_db"] == round(agg[k], 4) for k in fields)
        if not (same and line["utterances"] == agg["utterances"] > 0
                and all(math.isfinite(line[f"{k}_db"]) for k in fields)):
            raise AssertionError(f"cli evaluate {path.name}: {line}, in process {agg}")
        phase("score", f"{path.name}: cli evaluate {json.dumps(line)} (finite, equal to "
              f"evaluate_directory in process)")

    # the overfit protocol of scripts/fixture_quality_run.py on a synthetic
    # fixture: one batch of 4 easy utterances, train == test, fp32, full width
    with tempfile.TemporaryDirectory(prefix="chip_smoke_quality_") as tmp:
        tmp = pathlib.Path(tmp)
        root = make_synthetic_fixture(tmp / "fixture", utterances_per_split={"tr": 4, "cv": 1, "tt": 1})
        b = next(iter(WaveformLoader(root / "tr", batch_size=4)))
        arrays = tuple(torch.from_numpy(a).to(device) for a in (b.mix, b.sources, b.frame_lengths))
        model = UPitBlstm(generator=torch.Generator().manual_seed(0)).to(device)
        scores = {}

        def score(step):
            separate_directory(model, root / "tr", tmp / f"sep_{step}", batch_size=4)
            _, scores[step] = evaluate_directory(root, tmp / f"sep_{step}", split="tr")

        score(0)
        state = train_mod.TrainState.create(model, train_mod.exponential_decay_adam(decay_steps=2000),
                                            seed=0)
        ts, _ = train_mod.make_upit_waveform_steps(model)
        t0 = time.perf_counter()
        losses = [ts(state, *arrays)[1] for _ in range(QUALITY_STEPS)]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        score(QUALITY_STEPS)
    first, last = scores[0], scores[QUALITY_STEPS]
    gain = last["si_sdri"] - first["si_sdri"]
    if not (all(math.isfinite(s[k]) for s in (first, last) for k in fields) and gain >= QUALITY_GAIN_DB):
        raise AssertionError(f"quality run: untrained {first}, after {QUALITY_STEPS} steps {last}")
    phase("quality", f"UPitBlstm fp32, {QUALITY_STEPS} steps on one batch of 4 easy-profile "
          f"utterances (train == test, exponential_decay_adam decay 2000, dropout 0.8) in "
          f"{seconds:.1f} s, loss {losses[0].item():.2f} -> {losses[-1].item():.2f}: SI-SDR "
          f"{last['si_sdr']:.4f} dB, SI-SDRi {last['si_sdri']:.4f} dB, BSS SDR {last['sdr']:.4f} dB; "
          f"untrained (seed 0) {first['si_sdr']:.4f}, {first['si_sdri']:.4f}, {first['sdr']:.4f}; "
          f"SI-SDRi gain {gain:.4f} dB >= {QUALITY_GAIN_DB}")


if __name__ == "__main__":
    sys.exit(main())
