"""Device ms a batch in SepFormer's dual-path transformer: the CUDA timing
events that the port's ``sst.sepformer.intra`` and ``.inter`` spans record on
the current stream around each half (``models/dprnn.py::_DualPathBlock`` in
``models/sepformer.py``, one of each a block a forward;
``utils/profiling.py::span(..., device=True)``): the transformer layers, the
norms and the residuals as the device ran them,
summed over the traced window. None untraced, on a program whose
``utils/profiling.py`` has no ``device_ms``, or where no such span was
recorded."""

from speech_separation_tpu_torch.utils import profiling

SPANS = ("sst.sepformer.intra", "sst.sepformer.inter")


def read(w):
    device_ms = getattr(profiling, "device_ms", None)  # a program before device spans has none
    if w.trace is None or device_ms is None:
        return None
    times = [t for name in SPANS for t in device_ms(name)]
    return sum(times) / len(w.items) if times else None
