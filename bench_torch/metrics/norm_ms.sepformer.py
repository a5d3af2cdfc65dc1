"""Device ms a batch in every launch whose kernel name holds ``layer_norm``:
the dual-path transformer's LayerNorms. Where they run as PyTorch's
operations that is ``vectorized_layer_norm_kernel`` alone (the residual adds
and the casts to bf16 are other launches); where they run in the port's fused
kernel (``residual_layer_norm_kernel``) it holds those adds and casts too.
None where no such launch ran."""

from bench_torch import trace as tr


def is_layer_norm(e) -> bool:
    return e.kind == "kernel" and "layer_norm" in e.name


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, is_layer_norm)
    if not events:
        return None
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)
