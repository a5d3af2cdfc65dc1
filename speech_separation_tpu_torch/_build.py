"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled with ``nvcc`` into one shared library with a plain C
interface, at the first CUDA call, and loaded with :mod:`ctypes`. The library
name carries a hash of the sources and flags, so a stale build is never
loaded. Builds go to ``.kernel_build/`` inside the package, which git ignores.

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

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "find_nvcc", "nvcc_command", "library", "check"]

_PACKAGE = pathlib.Path(__file__).resolve().parent
SOURCES = tuple(sorted((_PACKAGE / "csrc").glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_DIR = _PACKAGE / ".kernel_build"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # signal, basis, out, batch, samples, frames, size, shift, cols, stream
    "sst_stft_analysis": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # xw, u, h_a, h_b, c, out, dirs, batch, steps, hidden, reverse_mask, bf16, stream
    "sst_lstm_recurrence": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
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


def nvcc_command(nvcc: str, output: str | os.PathLike) -> list[str]:
    """The compiler command that builds every source into ``output``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(output), *(str(s) for s in SOURCES)]


def _library_path() -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsst_kernels_{digest.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            nvcc_command(find_nvcc(), tmp), capture_output=True, text=True, check=False
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


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
