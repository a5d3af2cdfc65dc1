"""Host ms a hop in the port's ``sst.stream.apply`` span
(``separate/streaming.py::StreamingSeparator.push``): the window to the
device and every launch of the hop, ``cuda_apply``'s weight restacking
(``weights_ms.stream``) among them, with no wait for the device."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "sst.stream.apply")
