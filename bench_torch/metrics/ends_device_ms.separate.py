"""Device ms a batch at the two ends of a dual-path or T-F separator's forward:
the CUDA timing events that the port's ``sst.<model>.encode`` and ``.decode``
spans record on the current stream (``models/dprnn.py``,
``models/sepformer.py``, ``models/tfgridnet.py``, one of each a forward;
``utils/profiling.py::span(..., device=True)``): the encoder or STFT, the
input norm, the bottleneck and the chunking; the mask head, overlap-add and
decoder or iSTFT, as the device ran them, over whichever model the cell runs,
summed over the traced window. None untraced, on a program whose
``utils/profiling.py`` has no ``device_ms``, or where no such span was
recorded."""

from speech_separation_tpu_torch.utils import profiling

SPANS = (
    "sst.dprnn.encode",
    "sst.dprnn.decode",
    "sst.sepformer.encode",
    "sst.sepformer.decode",
    "sst.tfgridnet.encode",
    "sst.tfgridnet.decode",
)


def read(w):
    device_ms = getattr(profiling, "device_ms", None)  # a program before device spans has none
    if w.trace is None or device_ms is None:
        return None
    times = [t for name in SPANS for t in device_ms(name)]
    return sum(times) / len(w.items) if times else None
