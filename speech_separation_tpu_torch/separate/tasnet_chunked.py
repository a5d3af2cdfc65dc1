"""Arbitrary-length Conv-TasNet serving via overlapped chunks (counterpart of
``separate/tasnet_chunked.py``).

The waveform is cut into fixed-size overlapping chunks, separated as one
batch (one shape for any input length), then stitched on the host:

- **permutation alignment**: each chunk's speaker order is aligned to the
  stitched signal so far by maximising cross-correlation over the overlap
  (greedy chaining; exact for 2 speakers, best of S! in general);
- **crossfade**: overlaps are blended with complementary linear ramps.

gLN statistics become chunk-local instead of utterance-global: an
approximation bought for O(chunk) memory and one shape per chunk length.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["separate_chunked"]


def _chunk_starts(samples: int, chunk: int, hop: int) -> list[int]:
    if samples <= chunk:
        return [0]
    starts = list(range(0, samples - chunk + 1, hop))
    if starts[-1] + chunk < samples:
        starts.append(samples - chunk)
    return starts


def separate_chunked(
    apply_fn,
    mix: np.ndarray,
    *,
    num_speakers: int = 2,
    sample_rate: int = 8000,
    chunk_seconds: float = 8.0,
    overlap_seconds: float = 1.0,
    batch_quantum: int = 4,
) -> np.ndarray:
    """Separate one waveform of any length with a fixed-shape model call.

    ``apply_fn(mix_batch [N, chunk]) -> [N, S, chunk]`` is the separator
    (the module's forward or ``cuda_apply``), taking a CPU float32 tensor
    (it moves it to its device) and returning a tensor on any device. It is
    invoked once with all chunks stacked as a batch, zero-padded to a
    multiple of ``batch_quantum`` rows, so utterances of different lengths
    share a small set of shapes. Returns ``[S, samples]`` fp32.
    """
    mix = np.asarray(mix, np.float32)
    samples = mix.shape[-1]
    chunk = int(round(chunk_seconds * sample_rate))
    overlap = int(round(overlap_seconds * sample_rate))
    if not 0 < overlap < chunk:
        raise ValueError(f"need 0 < overlap ({overlap}) < chunk ({chunk})")
    hop = chunk - overlap

    starts = _chunk_starts(samples, chunk, hop)
    n_pad = -(-len(starts) // batch_quantum) * batch_quantum
    batch = np.zeros((n_pad, chunk), np.float32)
    for i, s in enumerate(starts):
        seg = mix[s : s + chunk]
        batch[i, : seg.shape[0]] = seg

    est = apply_fn(torch.from_numpy(batch)).detach().float().cpu().numpy()[: len(starts)]
    n, s_dim, _ = est.shape
    assert s_dim == num_speakers

    out = np.zeros((num_speakers, samples), np.float32)
    weight = np.zeros((samples,), np.float32)
    perms = list(itertools.permutations(range(num_speakers)))

    prev_perm = tuple(range(num_speakers))
    prev_end = None  # (start+chunk) of the previous chunk, for overlap calc
    for i, st in enumerate(starts):
        seg = est[i]  # [S, chunk]
        if i > 0:
            # align this chunk's speaker order to the stitched signal so far
            # using the overlap with the previous chunk
            ov_lo = st
            ov_hi = min(prev_end, st + chunk, samples)
            span = ov_hi - ov_lo
            if span > 0:
                ref = out[:, ov_lo:ov_hi]  # previous content (weighted sums)
                cand = seg[:, : span]
                best, best_score = prev_perm, -np.inf
                for p in perms:
                    score = sum(
                        float(np.dot(ref[k], cand[p[k]])) for k in range(num_speakers)
                    )
                    if score > best_score:
                        best, best_score = p, score
                seg = seg[list(best)]
                prev_perm = best
        valid = min(chunk, samples - st)
        ramp = np.ones((valid,), np.float32)
        if i > 0:
            rise = min(overlap, valid)
            ramp[:rise] = np.linspace(0.0, 1.0, rise, endpoint=False)
        if st + chunk < samples:
            # complementary to the next chunk's rise: fall(k) + rise(k) = 1
            fall = min(overlap, valid)
            ramp[valid - fall :] = np.minimum(
                ramp[valid - fall :], np.linspace(1.0, 0.0, fall, endpoint=False)
            )
        out[:, st : st + valid] += seg[:, :valid] * ramp
        weight[st : st + valid] += ramp
        prev_end = st + chunk
    weight = np.maximum(weight, 1e-8)
    return out / weight[None, :]
