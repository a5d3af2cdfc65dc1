"""Training, closed loop: the next step goes in when the last one returns,
as ``train.fit`` runs an epoch (batches through
``data.datasets.prefetch_to_device``, losses left on the device). The window
ends in a synchronise.

Set-up builds the one training object the window then drives, and takes it
through its first three steps on the first three batches of the shuffled
order, through the window's own feed and call. Those steps are checked
against the plain fp32 reference following the same three steps from the
same weights, on the same rows, with the same dropout bits:

- ``loss_gap``: the worst of the three steps' losses, relative to the
  reference's;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient (the program's worked out from its optimizer's first moment after
  one step), relative to the larger of that leaf's reference norm and the
  median leaf's;
- ``change_gap``: the same for the parameters' change over the three
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (below that, Adam moves a leaf by round-off alone).
"""

from __future__ import annotations

import itertools
import statistics
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from bench_torch import faults, traffic
from speech_separation_tpu_torch.data.datasets import prefetch_to_device

CHECK_STEPS = 3
TINY_GRADIENT = 1e-3  # of the median leaf's reference gradient norm


class Feed(NamedTuple):
    mix: np.ndarray
    sources: np.ndarray
    frame_lengths: np.ndarray
    index: int


@dataclass
class State:
    corpus: traffic.Corpus
    frame_lengths: list[np.ndarray]
    trainer: object
    losses: list[float] = field(default_factory=list)
    grad_norms: dict = field(default_factory=dict)
    change_norms: dict = field(default_factory=dict)


def _trainer(run):
    if run.mode == "program":
        model = run.program.build(run.cfg, run.weights, run.device)
        return run.program.Trainer(model, run.cfg, run.seed)
    return run.reference.Trainer(run.weights, run.cfg, run.seed, run.precision)


def _feed(st: State, positions, stop: threading.Event):
    order = st.corpus.order
    for position in positions:
        if stop.is_set():
            return
        i = int(order[position % len(order)])
        b = st.corpus.batches[i]
        yield Feed(b.mix, b.sources, st.frame_lengths[i], i)


def _steps(run, st: State, positions, deadline_s: float | None, each=None):
    """Train on the batches at ``positions``; returns the items and the
    seconds to the synchronise after the last step."""
    stop = threading.Event()
    batches = prefetch_to_device(_feed(st, positions, stop), run.device)
    items = []
    t0 = time.perf_counter()
    try:
        while True:
            with run.span("feed"):  # the next batch pinned and sent, in this thread
                fb = next(batches, None)
            if fb is None:
                break
            with run.span("step"):
                loss = st.trainer.step(fb.mix, fb.sources, fb.frame_lengths)
            batch = st.corpus.batches[fb.index]
            items.append({
                "rows": len(batch.sample_lengths), "samples": batch.mix.shape[1],
                "audio_s": float(batch.sample_lengths.sum()) / st.corpus.sample_rate,
                "frames": int(run.reference.frames(run.cfg, batch.sample_lengths).sum()),
            })
            if each is not None:
                each(loss)
            if deadline_s is not None and time.perf_counter() - t0 >= deadline_s:
                break
    finally:
        stop.set()
        for _ in batches:
            pass
    with run.span("synchronize"):
        torch.cuda.synchronize(run.device) if run.device.type == "cuda" else None
    return items, time.perf_counter() - t0


def setup(run) -> State:
    corpus = traffic.corpus(run.traffic, run.seed, run.device)
    frame_lengths = [np.asarray(run.reference.frames(run.cfg, b.sample_lengths), np.int32)
                     for b in corpus.batches]
    st = State(corpus, frame_lengths, faults.trainer(_trainer(run), run.fault))

    def read(loss):
        st.losses.append(float(loss))
        if len(st.losses) == 1:
            st.grad_norms = st.trainer.first_grad_norms()

    _steps(run, st, range(CHECK_STEPS), None, each=read)
    with torch.no_grad():
        st.change_norms = {k: (p.detach() - run.weights[k]).double().norm().item()
                           for k, p in st.trainer.parameters().items()}
    # warm up every batch shape (rows, padded length) the window will feed that the check missed
    seen = {corpus.batches[int(corpus.order[p])].mix.shape for p in range(CHECK_STEPS)}
    warm = []
    for position, i in enumerate(corpus.order):
        if corpus.batches[i].mix.shape not in seen:
            seen.add(corpus.batches[i].mix.shape)
            warm.append(position)
    _steps(run, st, warm, None)
    return st


def window(run, st: State, seconds: float):
    return _steps(run, st, itertools.count(CHECK_STEPS), seconds)


def release(st: State) -> None:
    st.trainer = None


def _gaps(got: dict, want: dict, keys) -> dict[str, float]:
    median = statistics.median(want.values())
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys}


def _gap(got: dict, want: dict, keys) -> float:
    return max(_gaps(got, want, keys).values())


def _worst(got: dict, want: dict, keys) -> str:
    gaps = _gaps(got, want, keys)
    k = max(gaps, key=gaps.get)
    return f"{k} (norm {want[k]:.4g}, median {statistics.median(want.values()):.4g})"


def compare(run, st: State) -> dict[str, float]:
    ref = run.reference.Trainer(run.weights, run.cfg, run.seed, run.baseline)
    losses, grads = [], {}
    for p in range(CHECK_STEPS):
        i = int(st.corpus.order[p])
        b = st.corpus.batches[i]
        dev = lambda a: torch.from_numpy(a).to(run.device)  # noqa: E731
        losses.append(float(ref.step(dev(b.mix), dev(b.sources), dev(st.frame_lengths[i]))))
        if p == 0:
            grads = {k: g.double().norm().item() for k, g in ref.last_grads.items()}
    with torch.no_grad():
        change = {k: (v.detach() - run.weights[k]).double().norm().item()
                  for k, v in ref.parameters().items()}
    if len(st.losses) != CHECK_STEPS or set(st.grad_norms) != set(grads):
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    median_grad = statistics.median(grads.values())
    moved = [k for k in grads if grads[k] >= TINY_GRADIENT * median_grad]
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(st.losses, losses)]
    print("train: loss gap by step " + ", ".join(f"{g:.3g}" for g in steps)
          + f"; worst leaf, gradient: {_worst(st.grad_norms, grads, grads)}"
          + f"; worst leaf, change: {_worst(st.change_norms, change, moved)}",
          file=sys.stderr, flush=True)
    return {
        "loss_gap": max(steps),
        "grad_gap": _gap(st.grad_norms, grads, grads),
        "change_gap": _gap(st.change_norms, change, moved),
    }
