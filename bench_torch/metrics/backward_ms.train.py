"""Host ms a training step in the port's ``sst.train.backward`` span
(``train/steps.py``'s ``train_step``): the host in ``loss.backward()``,
while the autograd engine's own thread launches the backward."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "sst.train.backward")
