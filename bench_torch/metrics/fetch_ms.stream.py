"""Host ms a hop in the port's ``sst.stream.fetch`` span
(``separate/streaming.py::StreamingSeparator.push``): the host blocked in
``.cpu()`` until the hop's device work and its estimate's copy are done."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "sst.stream.fetch")
