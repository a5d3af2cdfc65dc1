"""Device ms a training step in the port's ``sst.train.backward`` span
(``train/steps.py``'s ``train_step``): the CUDA timing events it records on
the caller's stream around ``loss.backward()``
(``utils/profiling.py::span(..., device=True)``), which bracket the kernels
that the autograd engine's thread queues there (rows 3 and 4 backward and
the gradient GEMMs),
summed over the traced window. None untraced, on a program whose
``utils/profiling.py`` has no ``device_ms``, or where no such span was
recorded."""

from speech_separation_tpu_torch.utils import profiling

SPANS = ("sst.train.backward",)


def read(w):
    device_ms = getattr(profiling, "device_ms", None)  # a program before device spans has none
    if w.trace is None or device_ms is None:
        return None
    times = [t for name in SPANS for t in device_ms(name)]
    return sum(times) / len(w.items) if times else None
