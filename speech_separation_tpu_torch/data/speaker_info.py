"""wsj0 speaker metadata (a copy of ``data/speaker_info.py``, without JAX).

The reference bundles ``wsj0-train-spkrinfo.txt`` (lines of ``ID M|F``); the
first three characters of each side of a mixture name index it.
"""

from __future__ import annotations

import pathlib

__all__ = ["load_speaker_genders", "mixture_genders"]


def load_speaker_genders(path: str | pathlib.Path) -> dict[str, int]:
    """Parse ``ID M|F`` lines → {speaker_id: 1 for male, 0 for female}."""
    out: dict[str, int] = {}
    for line in pathlib.Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 2:
            continue
        out[parts[0]] = 1 if parts[1].lower() == "m" else 0
    return out


def mixture_genders(mixture_name: str, genders: dict[str, int]) -> tuple[int, int]:
    """Speaker genders for a wsj0-2mix name ``spkA..._snr_spkB..._snr[.wav]``:
    the speaker ID is the first three characters of each utterance segment."""
    parts = pathlib.Path(mixture_name).stem.split("_")
    if len(parts) < 3:
        raise ValueError(f"not a wsj0-2mix mixture name: {mixture_name!r}")
    return genders[parts[0][:3]], genders[parts[2][:3]]
