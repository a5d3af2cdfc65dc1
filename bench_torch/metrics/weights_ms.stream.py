"""Host ms a hop in the port's ``sst.tasnet.weights`` span
(``models/tasnet_serving.py::cuda_apply``): the parameters copied to fp32
and the trunk's weight stacks rebuilt, every call; the trunk's own weight
transposes inside ``launch_trunk`` are outside it."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "sst.tasnet.weights")
