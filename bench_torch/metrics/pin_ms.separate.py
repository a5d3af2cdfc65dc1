"""Host ms a batch in the port's ``sst.feed.pin`` span
(``data/datasets.py::_to_device``): the batch's fields pinned and their
non-blocking copies queued. The mean over the spans, not over the window's
items: ``prefetch_to_device`` pins a batch ahead, and the feed's drain at
the window's end pins the batches already decoded, a few more than the
window takes."""

from bench_torch import trace as tr
from bench_torch.readers import host_ms_per_item

SPAN = "sst.feed.pin"


def read(w):
    per_item = host_ms_per_item(w, SPAN)
    if per_item is None:
        return None
    return per_item * len(w.items) / len(tr.host_events(w.trace, SPAN))
