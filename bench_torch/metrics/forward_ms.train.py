"""Host ms a training step in the port's ``sst.train.forward`` span
(``train/steps.py``'s ``train_step``): the loss's forward launched, up to
the loss tensor (no wait for the device)."""

from bench_torch.readers import host_ms_per_item


def read(w):
    return host_ms_per_item(w, "sst.train.forward")
