"""Device ms a training step in cuBLAS's kernels (the BLSTM's input
projections, Dense layers, heads and their gradients; the STFT's and
iSTFT's products), by kernel name."""

from bench_torch.readers import device_ms_per_item

CUBLAS = ("gemm", "xmma", "cutlass", "Kernel2", "sm90_")


def read(w):
    return device_ms_per_item(w, lambda e: e.kind == "kernel" and any(k in e.name for k in CUBLAS))
