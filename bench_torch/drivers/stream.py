"""Streaming separation, one stream at a time: each stream gets a new
``separate.streaming.StreamingSeparator`` and is pushed a hop at a time, the
next hop as soon as the last one's estimate is back on the host, as a caller
waiting on each hop pushes it. A hop's latency is the host's clock from
``push`` to its return. Streams follow one another in an order drawn from
the seed until the window's time is up.

Checked: every hop of the window's first stream, against the plain fp32
reference run on the same windows. ``hop_rel_err`` is the worst hop's
relative L2 error of the emitted estimates against the reference's estimates
of that window, put in the speaker order that the reference's own alignment
picks over the program's emitted history (the correlation over the context,
as ``StreamingSeparator`` aligns): a wrong estimate and a wrong order both
show. The narrowest margin of the reference's pick over the runner-up, which
would make an order ambiguous, is printed beside it.
"""

from __future__ import annotations

import itertools
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from bench_torch import faults, traffic
from speech_separation_tpu_torch.separate.streaming import StreamingSeparator

WARMUP_HOPS = 4


@dataclass
class State:
    streams: traffic.Streams
    order: np.ndarray
    apply_fn: object
    model: object
    outs: list[np.ndarray] = field(default_factory=list)


def _apply_fn(run):
    if run.mode == "program":
        model = run.program.build(run.cfg, run.weights, run.device)
        return run.program.stream_apply(model, run.cfg, run.device), model
    precision = run.precision

    def reference(window: torch.Tensor) -> torch.Tensor:
        return run.reference.separate(run.weights, run.cfg, window.to(run.device), None, precision)

    return reference, None


def _separator(run, st: State) -> StreamingSeparator:
    return StreamingSeparator(st.apply_fn, num_speakers=run.cfg["num_speakers"],
                              sample_rate=st.streams.sample_rate,
                              hop_seconds=st.streams.hop / st.streams.sample_rate,
                              context_seconds=st.streams.context / st.streams.sample_rate)


def setup(run) -> State:
    streams = traffic.streams(run.traffic, run.seed, run.device)
    order = np.random.default_rng([run.seed, 4]).permutation(streams.mixes.shape[0])
    apply_fn, model = _apply_fn(run)
    st = State(streams, order, faults.stream(apply_fn, run.fault), model)
    sep = _separator(run, st)
    mix = streams.mixes[order[-1]]
    for h in range(WARMUP_HOPS):
        sep.push(mix[h * streams.hop:(h + 1) * streams.hop])
    return st


def window(run, st: State, seconds: float):
    hop = st.streams.hop
    hops_a_stream = st.streams.mixes.shape[1] // hop
    items = []
    t0 = time.perf_counter()
    for k in itertools.count():
        mix = st.streams.mixes[st.order[k % len(st.order)]]
        sep = _separator(run, st)
        for h in range(hops_a_stream):
            t = time.perf_counter()
            with run.span("push"):
                out = sep.push(mix[h * hop:(h + 1) * hop])
            done = time.perf_counter()
            items.append({"rows": 1, "samples": sep.window, "audio_s": hop / st.streams.sample_rate,
                          "latency_s": done - t, "end_s": done - t0})
            if k == 0:
                st.outs.append(out)
            if done - t0 >= seconds:
                return items, done - t0
    raise AssertionError("unreachable")


def release(st: State) -> None:
    st.apply_fn = st.model = None


def compare(run, st: State) -> dict[str, float]:
    n = len(st.outs)
    if n == 0:
        return {"hop_rel_err": float("inf")}
    hop, context = st.streams.hop, st.streams.context
    width = context + hop
    seq = np.concatenate([np.zeros(width, np.float32), st.streams.mixes[st.order[0]]])
    windows = torch.from_numpy(np.stack([seq[(i + 1) * hop:(i + 1) * hop + width]
                                         for i in range(n)])).to(run.device)
    ref = run.reference.separate(run.weights, run.cfg, windows, None, run.baseline)
    ref = ref.double().cpu().numpy()
    speakers = ref.shape[1]
    orders = list(itertools.permutations(range(speakers)))
    errs, margin = [], float("inf")
    history = np.zeros((speakers, 0))
    for i in range(n):
        best = tuple(range(speakers))
        span = min(context, history.shape[1])
        if span > 0:
            past = history[:, history.shape[1] - span:]
            region = ref[i][:, context - span:context]
            scores = sorted(((sum(float(past[k] @ region[p[k]]) for k in range(speakers)), p)
                             for p in orders), reverse=True)
            best = scores[0][1]
            scale = sum(np.linalg.norm(past[k]) * np.linalg.norm(region[k]) for k in range(speakers))
            margin = min(margin, (scores[0][0] - scores[1][0]) / max(scale, 1e-30))
        want = ref[i][list(best), context:]
        got = st.outs[i].astype(np.float64)
        if got.shape != want.shape:
            return {"hop_rel_err": float("inf")}
        errs.append(float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)))
        history = np.concatenate([history, got], axis=1)[:, -width:]
    print(f"stream: the reference's narrowest margin between its best and runner-up speaker "
          f"order, over {n} hops: {margin:.6g} of the scores' bound", file=sys.stderr, flush=True)
    return {"hop_rel_err": max(errs)}
