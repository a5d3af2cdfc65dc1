"""The share of the window's LayerNorm launches (kernel names holding
``layer_norm``) that are the port's fused residual add and LayerNorm
(``residual_layer_norm_kernel``), in %: 0 where PyTorch's LayerNorm runs
them, 100 where every one is fused. None where no such launch ran."""

from bench_torch import trace as tr

FUSED = "residual_layer_norm"


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, lambda e: e.kind == "kernel" and "layer_norm" in e.name)
    if not events:
        return None
    return 100.0 * sum(FUSED in e.name for e in events) / len(events)
