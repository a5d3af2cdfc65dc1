"""Synthetic mini-fixture generation (counterpart of ``data/fixture.py``).

A numpy copy of the JAX package's generator, byte-identical for the same
seed: the wsj0-2mix directory layout (``{tr,cv,tt}/{mix,s1,s2}/*.wav`` plus
``lists/*.lst``) with synthetic speech-like sources and ``mix = s1 + s2``, and
the Libri2Mix-shaped tree of :func:`make_synthetic_librimix`
(``{band}/{condition}/{split}/{mix_clean,s1..sN}``), so tests and
``chip_smoke.py`` have corpora without JAX or a download.
"""

from __future__ import annotations

import pathlib
import zlib

import numpy as np

from .audio_io import audiowrite

__all__ = ["make_synthetic_fixture", "make_synthetic_librimix"]


def _voice_like(rng: np.random.Generator, samples: int, f0: float, sr: int) -> np.ndarray:
    """A crude voiced signal: drifting f0 with harmonics, amplitude envelope."""
    t = np.arange(samples) / sr
    drift = 1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t)
    phase = 2 * np.pi * f0 * np.cumsum(drift) / sr
    sig = np.zeros(samples)
    for h, a in enumerate([1.0, 0.5, 0.3, 0.2], start=1):
        sig += a * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    envelope = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * t))
    sig = sig * envelope + 0.02 * rng.standard_normal(samples)
    return (0.3 * sig / np.abs(sig).max()).astype(np.float32)


def _voice_hard(rng: np.random.Generator, samples: int, f0: float, sr: int) -> np.ndarray:
    """A wsj0-2mix-difficulty synthetic voice (the "hard" corpus profile).

    Unlike :func:`_voice_like` (4 fixed harmonics, disjoint per-speaker f0
    bands — trivially separable by frequency), this source is built to make
    separation genuinely hard when two of them share a pitch band:

    - f0 trajectory with vibrato AND a random walk (no stable pitch track);
    - formant-shaped harmonic spectrum (two random resonances + rolloff),
      so speakers differ by timbre, not by band;
    - syllabic amplitude envelope plus 1–3 silence gaps with 10 ms cosine
      ramps (onset/offset ambiguity across speakers);
    - an amplitude-modulated noise floor (breath/fricative stand-in) that
      is NOT gated with the voice.
    """
    t = np.arange(samples) / sr
    walk = np.cumsum(rng.standard_normal(samples))
    walk /= np.abs(walk).max() + 1e-9
    f0_t = f0 * (
        1.0
        + 0.05 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t + rng.uniform(0, 2 * np.pi))
        + 0.04 * walk
    )
    phase = 2 * np.pi * np.cumsum(f0_t) / sr

    centers = rng.uniform([300.0, 900.0], [800.0, 2500.0])
    widths = rng.uniform(80.0, 250.0, size=2)
    rolloff = rng.uniform(0.6, 0.85)
    n_harm = int(min(16, max(2, (sr / 2 - 200) // f0)))
    sig = np.zeros(samples)
    for h in range(1, n_harm + 1):
        fh = h * f0
        amp = rolloff ** (h - 1) * (
            0.25
            + np.exp(-(((fh - centers[0]) / widths[0]) ** 2))
            + 0.7 * np.exp(-(((fh - centers[1]) / widths[1]) ** 2))
        )
        sig += amp * np.sin(h * phase + rng.uniform(0, 2 * np.pi))

    envelope = 0.35 + 0.65 * np.abs(
        np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, np.pi))
    )
    sig *= envelope

    ramp = int(0.01 * sr)
    gate = np.ones(samples)
    for _ in range(int(rng.integers(1, 4))):
        gap = int(rng.uniform(0.15, 0.5) * sr)
        if gap + 2 * ramp >= samples:
            continue
        start = int(rng.integers(0, samples - gap - 2 * ramp))
        fade = 0.5 * (1 + np.cos(np.linspace(0, np.pi, ramp)))
        gate[start : start + ramp] = np.minimum(gate[start : start + ramp], fade)
        gate[start + ramp : start + ramp + gap] = 0.0
        gate[start + ramp + gap : start + 2 * ramp + gap] = np.minimum(
            gate[start + ramp + gap : start + 2 * ramp + gap], fade[::-1]
        )
    sig *= gate

    sig = 0.3 * sig / (np.abs(sig).max() + 1e-9)
    am = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * rng.uniform(2.0, 8.0) * t))
    noise_level = rng.uniform(0.015, 0.05)
    sig = sig + 0.3 * noise_level * am * rng.standard_normal(samples)
    return sig.astype(np.float32)


def _hard_f0s(rng: np.random.Generator, num_speakers: int) -> np.ndarray:
    """Per-speaker f0s from ONE overlapping band (log-uniform 90–250 Hz);
    with probability 0.5 every extra speaker is pinned within ±8% of speaker
    one's pitch — the same-pitch-band mixtures where separation is hardest."""
    f0s = np.exp(rng.uniform(np.log(90.0), np.log(250.0), size=num_speakers))
    if num_speakers > 1 and rng.uniform() < 0.5:
        f0s[1:] = f0s[0] * rng.uniform(0.92, 1.08, size=num_speakers - 1)
    return f0s


def _gain_offsets_db(rng: np.random.Generator, num_speakers: int) -> np.ndarray:
    """wsj0-2mix-style per-source gain offsets (dB). For S=2 the symmetric
    ±g convention the reference encodes in filenames
    (`use_this/tt/mix/447o0302_0.62948_441c0212_-0.62948.wav`); for S>2,
    zero-mean uniform offsets in the same ±2.5 dB range."""
    if num_speakers == 2:
        g = rng.uniform(0.0, 2.5)
        return np.array([g, -g])
    offs = rng.uniform(-2.5, 2.5, size=num_speakers)
    return offs - offs.mean()


def make_synthetic_fixture(
    root: str | pathlib.Path,
    utterances_per_split: int | dict[str, int] = 4,
    sample_rate: int = 8000,
    min_seconds: float = 2.0,
    max_seconds: float = 5.0,
    seed: int = 0,
    num_speakers: int = 2,
    profile: str = "easy",
) -> pathlib.Path:
    """Create the fixture tree under ``root``; returns ``root``.

    ``profile="easy"`` (default): disjoint per-speaker f0 bands, 0 dB mixing
    — separable by frequency alone (the original smoke-test regime, kept
    byte-identical). ``profile="hard"``: overlapping pitch bands, per-source
    gain offsets, AM noise and silence gaps (:func:`_voice_hard`) —
    wsj0-2mix-like difficulty. ``num_speakers`` emits ``s1..sN`` subdirs
    (the reference is strictly 2-speaker). ``utterances_per_split`` may be
    a dict keyed by split name (``{"tr": 400, "cv": 50, "tt": 50}``) for
    corpus-shaped fixtures with a large train split."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    (root / "lists").mkdir(parents=True, exist_ok=True)
    for split in ("tr", "cv", "tt"):
        count = (
            utterances_per_split[split]
            if isinstance(utterances_per_split, dict)
            else utterances_per_split
        )
        names = []
        for sub in ("mix", *(f"s{k + 1}" for k in range(num_speakers))):
            (root / split / sub).mkdir(parents=True, exist_ok=True)
        for i in range(count):
            seconds = rng.uniform(min_seconds, max_seconds)
            samples = int(seconds * sample_rate)
            if profile == "easy" and num_speakers == 2:
                srcs = [
                    _voice_like(rng, samples, rng.uniform(90, 150), sample_rate),
                    _voice_like(rng, samples, rng.uniform(180, 260), sample_rate),
                ]
                name = f"synth_{split}_{i:02d}.wav"
            else:
                srcs, offs = _make_sources(
                    rng, samples, sample_rate, num_speakers, profile
                )
                name = (
                    f"synth_{split}_{i:02d}_"
                    + "_".join(f"{o:.5f}" for o in offs)
                    + ".wav"
                )
            names.append(name)
            for k, s in enumerate(srcs):
                audiowrite(s, root / split / f"s{k + 1}" / name, sample_rate)
            audiowrite(sum(srcs), root / split / "mix" / name, sample_rate)
        (root / "lists" / f"{split}_wav.lst").write_text("\n".join(names) + "\n")
    return root


def _make_sources(rng, samples, sr, num_speakers, profile):
    """Sources + per-source dB offsets for one utterance (non-easy regimes)."""
    if profile == "hard":
        f0s = _hard_f0s(rng, num_speakers)
        offs = _gain_offsets_db(rng, num_speakers)
        voices = [_voice_hard(rng, samples, f0, sr) for f0 in f0s]
    else:  # easy voices, n-speaker: disjoint bands spread over 90-260 Hz
        lo, hi = 90.0, 260.0
        edges = np.linspace(lo, hi, num_speakers + 1)
        f0s = [rng.uniform(edges[k], edges[k + 1]) for k in range(num_speakers)]
        offs = np.zeros(num_speakers)
        voices = [_voice_like(rng, samples, f0, sr) for f0 in f0s]
    return [v * 10.0 ** (o / 20.0) for v, o in zip(voices, offs)], offs


def make_synthetic_librimix(
    root: str | pathlib.Path,
    utterances: dict[str, int] | None = None,
    bands: tuple[str, ...] = ("wav8k", "wav16k"),
    conditions: tuple[str, ...] = ("max", "min"),
    min_seconds: float = 2.0,
    max_seconds: float = 6.0,
    seed: int = 0,
    num_speakers: int = 2,
    profile: str = "easy",
) -> pathlib.Path:
    """Create a Libri2Mix-shaped corpus tree with synthetic audio.

    Layout: ``{root}/{band}/{condition}/{split}/{mix_clean,s1..sN}/*.wav`` —
    the tree the reference's bulk converters sweep
    (`parallel_stft_single.py:219-415`). ``utterances`` maps split name →
    count (default: the LibriMix split names at a scaled-down size). In the
    ``min`` condition sources are truncated to the shortest (LibriMix
    semantics); in ``max`` the shorter ones are zero-padded.

    ``profile``: the corpus difficulty regime, labeled on every benchmark.
      * ``"easy"`` — the round-1/2 corpus: disjoint f0 bands (90–150 vs
        180–260 Hz), 0 dB mixing. Trivially separable by frequency; dB
        headlines on it overstate model quality.
      * ``"hard"`` — wsj0-2mix-like difficulty: every speaker drawn from the
        SAME overlapping pitch band (50% of mixtures pinned within ±8% f0),
        per-source gain offsets encoded in the filename (the reference's
        ``utt1_+g_utt2_-g`` convention, e.g.
        `use_this/tt/mix/447o0302_0.62948_441c0212_-0.62948.wav`), formant
        timbres, AM noise floors and silence gaps.
    """
    root = pathlib.Path(root)
    if utterances is None:
        utterances = {"dev": 8, "test": 8, "train-100": 16, "train-360": 32}
    rng = np.random.default_rng(seed)
    easy2 = profile == "easy" and num_speakers == 2
    subs = ("mix_clean", *(f"s{k + 1}" for k in range(num_speakers)))
    for split, count in utterances.items():
        for i in range(count):
            secs = rng.uniform(min_seconds, max_seconds, size=num_speakers)
            if easy2:
                name = f"{split.replace('-', '')}_{i:05d}.wav"
            base = {}
            for band in bands:
                sr = 8000 if band == "wav8k" else 16000
                if easy2:
                    srcs = [
                        _voice_like(
                            np.random.default_rng(seed + i), int(secs[0] * sr),
                            90 + (i % 60), sr,
                        ),
                        _voice_like(
                            np.random.default_rng(seed + i + 1), int(secs[1] * sr),
                            180 + (i % 80), sr,
                        ),
                    ]
                else:
                    # per-utterance generator so both bands share f0s/offsets
                    urng = np.random.default_rng(
                        (seed, zlib.crc32(split.encode()), i)
                    )
                    full = int(secs.max() * sr)
                    srcs, offs = _make_sources(urng, full, sr, num_speakers, profile)
                    srcs = [s[: int(sc * sr)] for s, sc in zip(srcs, secs)]
                base[band] = (srcs, sr)
            if not easy2:
                name = (
                    f"{split.replace('-', '')}_{i:05d}_"
                    + "_".join(f"{o:.5f}" for o in offs)
                    + ".wav"
                )
            for band in bands:
                srcs, sr = base[band]
                for condition in conditions:
                    if condition == "min":
                        n = min(len(s) for s in srcs)
                        cut = [s[:n] for s in srcs]
                    else:
                        n = max(len(s) for s in srcs)
                        cut = [np.pad(s, (0, n - len(s))) for s in srcs]
                    split_dir = root / band / condition / split
                    for sub in subs:
                        (split_dir / sub).mkdir(parents=True, exist_ok=True)
                    for k, s in enumerate(cut):
                        audiowrite(s, split_dir / f"s{k + 1}" / name, sr)
                    audiowrite(sum(cut), split_dir / "mix_clean" / name, sr)
    return root
