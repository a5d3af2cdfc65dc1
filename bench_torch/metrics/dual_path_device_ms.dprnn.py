"""Device ms a batch in DPRNN's dual-path blocks: the CUDA timing events that
the port's ``sst.dprnn.intra`` and ``.inter`` spans record on the current
stream around each half (``models/dprnn.py::_DualPathBlock``, one of each a
block a forward; ``utils/profiling.py::span(..., device=True)``): the
BiLSTMs, their linear maps, gLN and the residuals as the device ran them,
summed over the traced window. None untraced, on a program whose
``utils/profiling.py`` has no ``device_ms``, or where no such span was
recorded."""

from speech_separation_tpu_torch.utils import profiling

SPANS = ("sst.dprnn.intra", "sst.dprnn.inter")


def read(w):
    device_ms = getattr(profiling, "device_ms", None)  # a program before device spans has none
    if w.trace is None or device_ms is None:
        return None
    times = [t for name in SPANS for t in device_ms(name)]
    return sum(times) / len(w.items) if times else None
