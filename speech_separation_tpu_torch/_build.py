"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` into one shared library with a plain C
interface, at the first CUDA call, and loaded with :mod:`ctypes`: one ``nvcc``
per source, all started together, then one link. The library name carries a
hash of the sources, their headers (``csrc/*.cuh``) and the flags, so a
stale build is never loaded. Builds go to ``.kernel_build/`` inside the
package, which git ignores.

Every C entry returns ``cudaGetLastError()`` after its launches; :func:`check`
raises on a non-zero code. A launch that is refused (too many threads, too
much shared memory) never runs, and ``torch.cuda.synchronize()`` would not
report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["SOURCES", "HEADERS", "NVCC_FLAGS", "BUILD_DIR", "find_nvcc", "nvcc_commands", "library", "check"]

_PACKAGE = pathlib.Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
HEADERS = tuple(sorted((_PACKAGE / "csrc").glob("*.cuh")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
BUILD_DIR = _PACKAGE / ".kernel_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # signal, table, out, batch, samples, frames, size, shift, pad, stream
    "sst_stft_analysis": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # xw, u, out, counters, dirs, batch, row0, rows, steps, hidden, reverse_mask,
    # bf16, groups, pass, resident, ahead, stream
    "sst_lstm_recurrence": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # xw, u, out, gates, c_all, keep, counters, then sst_lstm_recurrence's ints
    # and stream
    "sst_lstm_train_forward": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # gates, c_all, dy, u, keep, dgates, counters, dirs, batch, steps, hidden,
    # reverse_mask, bf16, groups, resident, stream
    "sst_lstm_train_backward": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # h0, h, skip, t1, t2, part, counters, we_t, wdw, wg_t, vecs, dils (host
    # int array), timing, batch, frames, cb, ch, vdim, taps, blocks, groups,
    # ctas, stream
    "sst_tcn_trunk": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # sst_tcn_trunk's arguments with hb, st after timing
    "sst_tcn_trunk_train": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # hb, st, dskip, dh, we, wdw, wcat, vecs, dils (host int array), dwe, dwdw,
    # dwcat, dvec, slabs, part, wpart, vpart, counters, timing, batch, frames,
    # cb, ch, vdim, taps, blocks, groups, ctas, stream
    "sst_tcn_trunk_backward": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    # flat, codebook, out, rows, ld, groups, dim, codes, ctas, resident, smem,
    # stream
    "sst_nearest_code": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, y, gamma, beta, out, rows, dim, y_bf16, out_bf16, eps, stream
    "sst_residual_layer_norm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, p, items, length, depth, scale, stream
    "sst_wide_attention_scores": (_P, _P, _P, _I, _I, _I, _F, _P),
    # logits, mask_b, feats, dec_k, dec_b, out, batch, frames, speakers,
    # channels, win, stride, left, samples, stream
    "sst_mask_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under PyTorch's ``CUDA_HOME``; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        candidate = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if candidate.is_file():
            return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build the CUDA kernels")


def nvcc_commands(nvcc: str, output: str | os.PathLike) -> list[list[str]]:
    """One compile command per source (``output`` stem + source stem + ``.o``),
    to run together, then the command that links them into ``output``."""
    output = pathlib.Path(output)
    objects = [output.with_name(f"{output.stem}_{s.stem}.o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(SOURCES, objects)]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(output), *(str(o) for o in objects)]
    return [*compiles, link]


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsst_kernels_{digest.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    *compiles, link = nvcc_commands(find_nvcc(), tmp)
    objects = [cmd[-1] for cmd in compiles]
    try:
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        outputs = [(proc.communicate()[0], proc.returncode) for proc in procs]
        for cmd, (text, code) in zip(compiles, outputs):
            if code != 0:
                raise RuntimeError(f"nvcc failed ({code}) on {cmd[-3]}:\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    finally:
        for leftover in (tmp, *objects):
            if os.path.exists(leftover):
                os.unlink(leftover)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            path = _library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sst_error_string.argtypes = (ctypes.c_int,)
            lib.sst_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(code: int, kernel: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        message = library().sst_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({message})")
