"""Device ms a hop in the decoder's launches: every kernel whose name holds
``dgrad`` (cuDNN's transposed conv, which ``F.conv_transpose1d`` runs as a
data-gradient kernel, the decoder of the port's chain of PyTorch operations)
or ``mask_decode`` (the port's kernel that takes the mask head's tail and the
decoder in one launch). None where no such launch ran."""

from bench_torch import trace as tr


def is_decoder(e) -> bool:
    return e.kind == "kernel" and ("dgrad" in e.name or "mask_decode" in e.name)


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, is_decoder)
    if not events:
        return None
    return sum(e.end - e.start for e in events) / 1e6 / len(w.items)
