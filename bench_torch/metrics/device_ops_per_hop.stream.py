"""Device operations (kernels, copies, memsets) a hop: the streaming
engine's launches, ``cuda_apply``'s weight restacking among them."""

from bench_torch.readers import device_ops_per_item


def read(w):
    return device_ops_per_item(w)
