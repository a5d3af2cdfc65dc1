"""Device ms a hop in the port's ``sst.stream.fetch`` span
(``separate/streaming.py::StreamingSeparator.push``), from the CUDA timing
events it records on the current stream around ``.cpu()``
(``utils/profiling.py::span(..., device=True)``), summed over the traced
window. The start event waits behind the hop's device work and the end one
is queued once the host has the estimate, so the interval is the copy to
the host and the host's turn to queue the end; the host span less it is the
host's wait for the hop. None untraced, on a program whose
``utils/profiling.py`` has no ``device_ms``, or where no such span was
recorded."""

from speech_separation_tpu_torch.utils import profiling

SPANS = ("sst.stream.fetch",)


def read(w):
    device_ms = getattr(profiling, "device_ms", None)  # a program before device spans has none
    if w.trace is None or device_ms is None:
        return None
    times = [t for name in SPANS for t in device_ms(name)]
    return sum(times) / len(w.items) if times else None
