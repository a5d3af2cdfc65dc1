"""The general traffic generator: reads a mix's parameters from
``traffic/<mix>.json`` and makes its inputs from the seed.

Two shapes of traffic:

- ``"kind": "corpus"``: a pool of two-source mixtures whose lengths are
  uniform on ``[min_seconds, max_seconds]``, drawn stratified (one length
  in each of ``utterances`` equal bins), so every seed gets the same set of
  sizes to within a bin and only the content and the order change. The pool
  is cut, length-sorted, into batches of ``batch`` utterances, each padded
  to the next multiple of ``pad_quantum_seconds`` (``WaveformLoader(
  sort_by_length=True)``'s grouping), in a batch order shuffled from the
  seed;
- ``"kind": "streams"``: ``streams`` two-source mixtures of
  ``stream_seconds`` each, pushed a hop at a time.

A source is Gaussian noise under a slow random amplitude envelope, silent
past its utterance's length; the mix is the sum of the sources. The content
does not change the work. Signals are made on the device, with a
``torch.Generator`` seeded from the seed, in one call a batch, and copied to
the host, where the program's feed takes them from.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Batch:
    mix: np.ndarray  # [B, samples] float32
    sources: np.ndarray | None  # [B, num_speakers, samples] float32, where kept
    sample_lengths: np.ndarray  # [B] int64, true samples of each utterance


@dataclass
class Corpus:
    batches: list[Batch]  # length-sorted groups
    order: np.ndarray  # the order the batches are fed in, shuffled from the seed
    sample_rate: int


@dataclass
class Streams:
    mixes: np.ndarray  # [streams, samples] float32
    hop: int  # samples a push
    context: int  # samples of trailing context a window
    sample_rate: int


def _check_seed(seed: int) -> int:
    if seed < 0:
        raise ValueError(f"seed {seed} is negative")
    return int(seed)


def utterance_samples(traffic: dict, seed: int) -> np.ndarray:
    """Ascending true lengths in samples, one drawn uniformly in each of
    ``utterances`` equal bins of ``[min_seconds, max_seconds]``."""
    n = int(traffic["utterances"])
    lo, hi = float(traffic["min_seconds"]), float(traffic["max_seconds"])
    rng = np.random.default_rng([_check_seed(seed), 1])
    seconds = lo + (hi - lo) * (np.arange(n) + rng.random(n)) / n
    return np.round(seconds * int(traffic["sample_rate"])).astype(np.int64)


def _synth(gen: torch.Generator, lengths: torch.Tensor, num_speakers: int, samples: int,
           sample_rate: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mix [B, samples], sources [B, S, samples])`` on ``gen``'s device."""
    device = gen.device
    b = lengths.shape[0]
    noise = torch.randn(b, num_speakers, samples, generator=gen, device=device)
    draws = torch.rand(b, num_speakers, 3, generator=gen, device=device)
    freq = 0.5 + 2.5 * draws[..., 0:1]  # the envelope's rate, Hz
    phase = 2 * math.pi * draws[..., 1:2]
    gain = 0.05 + 0.1 * draws[..., 2:3]
    t = torch.arange(samples, device=device, dtype=torch.float32) / sample_rate
    env = 0.3 + 0.7 * torch.sin(2 * math.pi * freq * t + phase).abs()
    live = (torch.arange(samples, device=device)[None, :] < lengths[:, None]).to(torch.float32)
    sources = noise * env * gain * live[:, None, :]
    return sources.sum(dim=1), sources


def corpus(traffic: dict, seed: int, device: torch.device) -> Corpus:
    """The corpus of a ``"kind": "corpus"`` mix (sources kept where
    ``"sources": true``)."""
    lengths = utterance_samples(traffic, seed)
    size = int(traffic["batch"])
    sr = int(traffic["sample_rate"])
    quantum = max(1, int(round(float(traffic["pad_quantum_seconds"]) * sr)))
    speakers = int(traffic["num_speakers"])
    gen = torch.Generator(device=device).manual_seed(_check_seed(seed))
    batches = []
    for start in range(0, len(lengths), size):
        group = lengths[start:start + size]
        padded = -(-int(group.max()) // quantum) * quantum
        mix, sources = _synth(gen, torch.as_tensor(group, device=device), speakers, padded, sr)
        batches.append(Batch(
            mix.cpu().numpy(),
            sources.cpu().numpy() if traffic.get("sources") else None,
            group.copy(),
        ))
    order = np.random.default_rng([_check_seed(seed), 2]).permutation(len(batches))
    return Corpus(batches, order, sr)


def streams(traffic: dict, seed: int, device: torch.device) -> Streams:
    """The streams of a ``"kind": "streams"`` mix."""
    sr = int(traffic["sample_rate"])
    samples = int(round(float(traffic["stream_seconds"]) * sr))
    n = int(traffic["streams"])
    gen = torch.Generator(device=device).manual_seed(_check_seed(seed))
    lengths = torch.full((n,), samples, device=device)
    mix, _ = _synth(gen, lengths, int(traffic["num_speakers"]), samples, sr)
    return Streams(mix.cpu().numpy(), int(round(float(traffic["hop_seconds"]) * sr)),
                   int(round(float(traffic["context_seconds"]) * sr)), sr)
