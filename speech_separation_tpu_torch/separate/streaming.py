"""Online (streaming) separation over sliding windows (counterpart of
``separate/streaming.py``).

Each ``push(hop)`` runs one fixed-shape model call on the trailing window of
``context + hop`` samples (inside ``ops.fixed_shape_calls()``, so a serving
path may replay its launches as one CUDA graph), emits the newest ``hop`` samples and aligns the
speaker order with the samples already emitted by correlation over the
context region: causal information only, as ``separate_chunked`` aligns its
chunks.

Latency: the algorithmic delay is one hop (a hop must arrive before it is
processed; the window ends at the newest sample); the compute latency is the
``push`` wall time, which must stay under the hop's duration for real-time
operation. The gLN statistics are window-local, the chunked pipeline's
approximation over the trailing window.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ..ops.dispatch import fixed_shape_calls
from ..utils.profiling import span

__all__ = ["StreamingSeparator", "stream_separate"]


class StreamingSeparator:
    """Hop-by-hop separator around ``apply_fn``.

    ``apply_fn(mix [1, window]) -> [1, S, window]`` takes a CPU float32 tensor
    (it moves it to its device) and returns a tensor on any device, as
    ``separate_chunked``'s does; ``window`` is ``context_seconds +
    hop_seconds`` in whole samples. The emitted hops concatenate to a waveform
    aligned with the pushed samples."""

    def __init__(
        self,
        apply_fn,
        *,
        num_speakers: int = 2,
        sample_rate: int = 8000,
        hop_seconds: float = 0.5,
        context_seconds: float = 1.5,
    ):
        self.apply_fn = apply_fn
        self.num_speakers = num_speakers
        self.sample_rate = sample_rate
        self.hop = int(round(hop_seconds * sample_rate))
        self.context = int(round(context_seconds * sample_rate))
        if self.hop <= 0 or self.context < 0:
            raise ValueError("need hop > 0 and context >= 0")
        if num_speakers > 1 and self.context <= 0:
            # the correlation over the context is all that keeps a PIT-trained
            # model's speaker order from swapping between hops
            raise ValueError(
                "multi-speaker streaming needs context_seconds > 0 for "
                "permutation alignment across hops"
            )
        self.window = self.context + self.hop
        self._buffer = np.zeros((self.window,), np.float32)  # trailing input
        self._history = np.zeros((num_speakers, 0), np.float32)  # emitted
        self._perms = list(itertools.permutations(range(num_speakers)))
        self._perm = tuple(range(num_speakers))

    def push(self, hop: np.ndarray) -> np.ndarray:
        """Feed exactly one hop of new samples; returns ``[S, hop]``."""
        hop = np.asarray(hop, np.float32)
        if hop.shape != (self.hop,):
            raise ValueError(f"push expects exactly {self.hop} samples")
        self._buffer = np.concatenate([self._buffer[self.hop :], hop])
        # every launch of the hop, no wait; every call on the one window shape
        with span("stream.apply"), fixed_shape_calls():
            out = self.apply_fn(torch.from_numpy(self._buffer[None]))
        # the host blocked on the hop's device work and its copy; on the device, the copy
        with span("stream.fetch", device=True):
            est = out.detach().float().cpu().numpy()[0]

        # permutation alignment over the causal context region
        lookback = min(self.context, self._history.shape[1])
        if lookback > 0:
            ref = self._history[:, self._history.shape[1] - lookback :]
            cand = est[:, self.context - lookback : self.context]
            best, best_score = self._perm, -np.inf
            for p in self._perms:
                score = sum(
                    float(np.dot(ref[k], cand[p[k]])) for k in range(self.num_speakers)
                )
                if score > best_score:
                    best, best_score = p, score
            self._perm = best
        out = est[list(self._perm), self.context :]
        self._history = np.concatenate([self._history, out], axis=1)
        # the alignment looks back `context` samples at most
        if self._history.shape[1] > 4 * self.window:
            self._history = self._history[:, -2 * self.window :]
        return out


def stream_separate(
    apply_fn,
    mix: np.ndarray,
    *,
    num_speakers: int = 2,
    sample_rate: int = 8000,
    hop_seconds: float = 0.5,
    context_seconds: float = 1.5,
) -> tuple[np.ndarray, list[float]]:
    """Stream a whole waveform through :class:`StreamingSeparator`.

    Returns ``([S, samples], per_hop_latency_seconds)``: the stitched output
    (the zero-padded last hop trimmed) and each ``push``'s wall-clock time,
    which includes fetching its estimate to the host."""
    mix = np.asarray(mix, np.float32)
    if mix.ndim == 2 and mix.shape[0] == 1:
        mix = mix[0]  # the loaders' [1, samples] row, as the stateful engine takes it
    sep = StreamingSeparator(
        apply_fn,
        num_speakers=num_speakers,
        sample_rate=sample_rate,
        hop_seconds=hop_seconds,
        context_seconds=context_seconds,
    )
    samples = mix.shape[-1]
    n_hops = -(-samples // sep.hop)
    padded = np.zeros((n_hops * sep.hop,), np.float32)
    padded[:samples] = mix
    outs, latencies = [], []
    for i in range(n_hops):
        t0 = time.perf_counter()
        outs.append(sep.push(padded[i * sep.hop : (i + 1) * sep.hop]))
        latencies.append(time.perf_counter() - t0)
    return np.concatenate(outs, axis=1)[:, :samples], latencies
