"""Bulk separation, closed loop: the next batch goes in when the last one's
estimates are back on the host, as ``separate_directory`` runs a split
(without the wav files).

Each batch of the corpus goes host → device through
``data.datasets.prefetch_to_device``, is separated by the configuration's
serving entry, and its estimates come back with ``.cpu()`` and are trimmed to
each utterance's true length. The corpus is fed in its shuffled batch order,
pass after pass, until the window's time is up; the window ends when the
last batch's estimates are on the host.

Checked: every utterance of two batches, the longest batch and one drawn
from the seed, as the window first produced them (or, where the window
closed before one came, as it comes after the close), against the plain
fp32 reference on the same padded mixtures: the worst relative L2 error of
an utterance's estimates over its true length (``est_rel_err``).
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from bench_torch import faults, traffic
from speech_separation_tpu_torch.data.datasets import prefetch_to_device


class Feed(NamedTuple):
    mix: np.ndarray
    frame_lengths: np.ndarray
    index: int  # the batch's place in the corpus (passes through the feed)


@dataclass
class State:
    corpus: traffic.Corpus
    frame_lengths: list[np.ndarray]
    system: object
    model: object
    check: tuple[int, ...]
    captured: dict[int, list[np.ndarray]] = field(default_factory=dict)


def _system(run):
    if run.mode == "program":
        model = run.program.build(run.cfg, run.weights, run.device)
        return run.program.separate_system(model, run.cfg), model
    precision = run.precision

    def reference(mix, frame_lengths):
        return run.reference.separate(run.weights, run.cfg, mix, frame_lengths, precision)

    return reference, None


def _feed(st: State, positions, stop: threading.Event):
    order = st.corpus.order
    for position in positions:
        if stop.is_set():
            return
        i = int(order[position % len(order)])
        yield Feed(st.corpus.batches[i].mix, st.frame_lengths[i], i)


def _run(run, st: State, positions, deadline_s: float | None):
    """Feed the batches at ``positions``; returns the window's items and
    its seconds (to the host's receipt of the last estimates)."""
    stop = threading.Event()
    batches = prefetch_to_device(_feed(st, positions, stop), run.device)
    items = []
    t0 = last = time.perf_counter()
    try:
        while True:
            with run.span("feed"):  # the next batch pinned and sent, in this thread
                fb = next(batches, None)
            if fb is None:
                break
            with run.span("separate"):
                out = st.system(fb.mix, fb.frame_lengths)
            with run.span("fetch"):
                wavs = out.cpu().numpy()
            batch = st.corpus.batches[fb.index]
            with run.span("trim"):
                est = [wavs[r, :, :n] for r, n in enumerate(batch.sample_lengths)]
            t = time.perf_counter()
            items.append({
                "rows": len(est), "samples": batch.mix.shape[1],
                "audio_s": float(batch.sample_lengths.sum()) / st.corpus.sample_rate,
                "frames": int(run.reference.frames(run.cfg, batch.sample_lengths).sum()),
                "latency_s": t - last, "end_s": t - t0,
            })
            last = t
            if fb.index in st.check and fb.index not in st.captured:
                st.captured[fb.index] = est
            if deadline_s is not None and t - t0 >= deadline_s:
                break
    finally:
        stop.set()
        for _ in batches:  # let the feed's worker thread finish
            pass
    return items, (items[-1]["end_s"] if items else 0.0)


def setup(run) -> State:
    corpus = traffic.corpus(run.traffic, run.seed, run.device)
    frame_lengths = [np.asarray(run.reference.frames(run.cfg, b.sample_lengths), np.int32)
                     for b in corpus.batches]
    system, model = _system(run)
    system = faults.separate(system, run.fault)
    longest = len(corpus.batches) - 1
    drawn = int(np.random.default_rng([run.seed, 3]).integers(0, longest)) if longest else 0
    st = State(corpus, frame_lengths, system, model, tuple(sorted({longest, drawn})))
    # warm up every batch shape (rows, padded length) the window will feed, once each
    seen, warm = set(), []
    for position, i in enumerate(corpus.order):
        if corpus.batches[i].mix.shape not in seen:
            seen.add(corpus.batches[i].mix.shape)
            warm.append(position)
    saved, st.check = st.check, ()
    _run(run, st, warm, None)
    st.check = saved
    return st


def window(run, st: State, seconds: float):
    return _run(run, st, itertools.count(), seconds)


def finish(run, st: State) -> None:
    """After the window: separate the checked batches it did not reach."""
    missing = [i for i in st.check if i not in st.captured]
    order = list(st.corpus.order)
    _run(run, st, [order.index(i) for i in missing], None)


def release(st: State) -> None:
    st.system = st.model = None


def compare(run, st: State) -> dict[str, float]:
    errs = []
    for i in st.check:
        est = st.captured.get(i)
        if est is None:  # never came back in the window
            return {"est_rel_err": float("inf")}
        batch = st.corpus.batches[i]
        mix = torch.from_numpy(batch.mix).to(run.device)
        ref = run.reference.separate(run.weights, run.cfg, mix,
                                     torch.from_numpy(st.frame_lengths[i]).to(run.device), run.baseline)
        for r, n in enumerate(batch.sample_lengths):
            want = ref[r, :, :n].double()
            got = torch.from_numpy(np.ascontiguousarray(est[r])).to(run.device).double()
            if got.shape != want.shape:
                return {"est_rel_err": float("inf")}
            errs.append(((got - want).norm() / want.norm().clamp_min(1e-30)).item())
    return {"est_rel_err": max(errs)}
