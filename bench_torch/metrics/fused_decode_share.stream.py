"""The share of the window's decoder launches (kernel names holding ``dgrad``
or ``mask_decode``) that are the port's fused mask-and-decode kernel
(``mask_decode_kernel``), in %: 0 where cuDNN's transposed conv decodes, 100
where every hop decodes in the fused kernel. None where no such launch ran."""

from bench_torch import trace as tr

FUSED = "mask_decode"


def read(w):
    if w.trace is None:
        return None
    events = tr.device_events(w.trace, lambda e: e.kind == "kernel" and (
        "dgrad" in e.name or FUSED in e.name))
    if not events:
        return None
    return 100.0 * sum(FUSED in e.name for e in events) / len(events)
