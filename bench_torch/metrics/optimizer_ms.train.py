"""Host ms a training step inside the optimizer's update (torch's own
``Optimizer.step#Adam.step`` span around ``train/optim.py::Adam.step``)."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "Optimizer.step#Adam.step")
