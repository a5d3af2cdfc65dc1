"""Directory-level separation scoring (counterpart of ``evaluate/evaluate.py``).

Walk ``{wav_dir}/{split}/mix``, pair each reference (``s1`` .. ``sN``) with
the estimates ``{est_dir}/{name}_s{i}.wav``, truncate all to the common
minimum length, score, average: permutation-best SI-SDR, its improvement over
the unprocessed mixture (SI-SDRi), and the BSS-eval images SDR/ISR/SIR/SAR of
``metrics/bss_eval.py``, with NaN-tolerant aggregation. Host-side numpy.
"""

from __future__ import annotations

import pathlib

import numpy as np

from ..data.audio_io import read_wav
from ..data.features import resolve_mix_dirname
from ..metrics.bss_eval import bss_eval_images, bss_eval_sources
from ..metrics.sisdr import permute_si_sdr

__all__ = ["eval_si_sdr", "eval_si_sdri", "eval_sdr", "score_pair", "evaluate_directory"]


def _detect_num_speakers(split_dir: pathlib.Path) -> int:
    s = 0
    while (split_dir / f"s{s + 1}").is_dir():
        s += 1
    return max(s, 2)


def _load_pairs(
    wav_dir: pathlib.Path,
    est_dir: pathlib.Path,
    split: str = "tt",
    num_speakers: int | None = None,
):
    """Pair references ``{split}/s1..sN`` with estimates ``{stem}_s1..sN.wav``.

    ``num_speakers=None`` autodetects N from the ``sN`` subdirectories
    (the reference is strictly 2-speaker; n-speaker is beyond-parity)."""
    split_dir = wav_dir / split
    mix_dir = split_dir / resolve_mix_dirname(split_dir)
    if num_speakers is None:
        num_speakers = _detect_num_speakers(split_dir)
    for name in sorted(p.name for p in mix_dir.glob("*.wav")):
        stem = pathlib.Path(name).stem
        refs = [read_wav(split_dir / f"s{i + 1}" / name)[0] for i in range(num_speakers)]
        ests = [
            read_wav(est_dir / f"{stem}_s{i + 1}.wav")[0] for i in range(num_speakers)
        ]
        n = min(min(r.size for r in refs), min(e.size for e in ests))
        yield name, tuple(r[:n] for r in refs), tuple(e[:n] for e in ests)


def eval_si_sdr(
    wav_dir: str | pathlib.Path, est_dir: str | pathlib.Path, split: str = "tt"
) -> float:
    """Mean permutation-best SI-SDR over the split (dB)."""
    scores = [
        permute_si_sdr(refs, ests)
        for _, refs, ests in _load_pairs(pathlib.Path(wav_dir), pathlib.Path(est_dir), split)
    ]
    return float(np.mean(scores))


def eval_si_sdri(
    wav_dir: str | pathlib.Path, est_dir: str | pathlib.Path, split: str = "tt"
) -> float:
    """Mean SI-SDR *improvement* over the unprocessed mixture (dB).

    The headline separation metric (SI-SNRi in the literature; BASELINE.json's
    north-star): permutation-best SI-SDR of the estimates minus the mean
    SI-SDR of the mixture itself against each reference.
    """
    wav_dir = pathlib.Path(wav_dir)
    improvements = []
    mixdir = resolve_mix_dirname(wav_dir / split)
    for name, refs, ests in _load_pairs(wav_dir, pathlib.Path(est_dir), split):
        mix, _ = read_wav(wav_dir / split / mixdir / name)
        n = refs[0].size
        mix = mix[:n]
        baseline = np.mean([permute_si_sdr(refs, (mix,) * len(refs))])
        improvements.append(permute_si_sdr(refs, ests) - baseline)
    return float(np.mean(improvements))


def eval_sdr(
    wav_dir: str | pathlib.Path,
    est_dir: str | pathlib.Path,
    split: str = "tt",
    flen: int = 512,
    version: str = "images",
) -> float:
    """Mean BSS-eval SDR (permutation-resolved) over the split (dB).

    ``version="images"`` (default) matches the reference's actual museval
    call (`evaluate_metrics.py:79-81` — museval's
    ``bsseval_sources_version=False`` default); ``"sources"`` selects the
    BSS Eval v3 sources variant.
    """
    evaluator = bss_eval_images if version == "images" else bss_eval_sources
    scores = []
    for _, refs, ests in _load_pairs(pathlib.Path(wav_dir), pathlib.Path(est_dir), split):
        result = evaluator(np.stack(refs), np.stack(ests), flen=flen)
        sdr = np.mean(result.sdr)
        if np.isnan(sdr):
            sdr = np.mean(np.nan_to_num(result.sdr))
        scores.append(sdr)
    return float(np.mean(scores))


def evaluate_directory(
    wav_dir: str | pathlib.Path,
    est_dir: str | pathlib.Path,
    split: str = "tt",
    flen: int = 512,
) -> tuple[list[dict], dict[str, float]]:
    """Score a separated split with every metric the reference reports.

    One decode pass per utterance computes SI-SDR, SI-SDRi (improvement over
    the unprocessed mixture — the north-star metric), and the BSS-eval
    SDR/SIR/SAR triple the reference got from
    ``museval.metrics.bss_eval(window=inf)``
    (`metrics/evaluate_metrics.py:57-92`). Returns ``(per_utterance,
    aggregate)``; aggregation is NaN-tolerant (``np.nan_to_num`` fallback,
    matching `evaluate_metrics.py:85-86`).
    """
    wav_dir = pathlib.Path(wav_dir)
    per_utterance: list[dict] = []
    mixdir = resolve_mix_dirname(wav_dir / split)
    for name, refs, ests in _load_pairs(wav_dir, pathlib.Path(est_dir), split):
        scores = score_pair(refs, ests, flen=flen)
        mix, _ = read_wav(wav_dir / split / mixdir / name)
        mix = mix[: refs[0].size]
        scores["si_sdri"] = scores["si_sdr"] - permute_si_sdr(refs, (mix,) * len(refs))
        per_utterance.append({"name": name, **scores})
    keys = ("si_sdr", "si_sdri", "sdr", "isr", "sir", "sar")
    aggregate = {
        k: float(np.mean(np.nan_to_num([u[k] for u in per_utterance]))) for k in keys
    }
    aggregate["utterances"] = len(per_utterance)
    return per_utterance, aggregate


def score_pair(references, estimates, flen: int = 512) -> dict[str, float]:
    """All metrics for one utterance: {si_sdr, sdr, isr, sir, sar}.

    The BSS-eval quadruple uses the *images* decomposition — the variant the
    reference's museval call returned (`evaluate_metrics.py:79-81`).
    """
    n = min(min(r.size for r in references), min(e.size for e in estimates))
    refs = np.stack([r[:n] for r in references])
    ests = np.stack([e[:n] for e in estimates])
    bss = bss_eval_images(refs, ests, flen=flen)
    return {
        "si_sdr": permute_si_sdr(list(refs), list(ests)),
        "sdr": float(np.mean(bss.sdr)),
        "isr": float(np.mean(bss.isr)),
        "sir": float(np.mean(bss.sir)),
        "sar": float(np.mean(bss.sar)),
    }
