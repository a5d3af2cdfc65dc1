"""Device ms a batch of host ↔ device copies: the mixture in
(``prefetch_to_device``) and the estimates out (``.cpu()``)."""

from bench_torch.readers import device_ms_per_item


def read(w):
    return device_ms_per_item(w, lambda e: e.kind == "gpu_memcpy"
                              and ("HtoD" in e.name or "DtoH" in e.name))
