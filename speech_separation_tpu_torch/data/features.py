"""Split-directory helpers (the loader's part of ``data/features.py``)."""

from __future__ import annotations

import pathlib

__all__ = ["utterance_names", "resolve_mix_dirname"]

_MIX_ALIASES = ("mix_clean", "mix_both", "mix_single")


def _candidates(mix_dirname: str) -> list[str]:
    return [mix_dirname, *(_MIX_ALIASES if mix_dirname == "mix" else ())]


def utterance_names(split_dir: pathlib.Path, mix_dirname: str = "mix") -> list[str]:
    """Wav names in a split (from ``lists/*.lst`` if present, else listdir).

    When the default ``mix`` directory is absent the LibriMix condition names
    are tried (``mix_clean``/``mix_both``/``mix_single``)."""
    split_dir = pathlib.Path(split_dir)
    lst = split_dir.parent / "lists" / f"{split_dir.name}_wav.lst"
    if lst.exists():
        return [line.strip() for line in lst.read_text().splitlines() if line.strip()]
    for name in _candidates(mix_dirname):
        if (split_dir / name).is_dir():
            return sorted(p.name for p in (split_dir / name).glob("*.wav"))
    return []


def resolve_mix_dirname(split_dir: pathlib.Path, mix_dirname: str = "mix") -> str:
    """First existing mixture dir: ``mix``, else the LibriMix condition names."""
    split_dir = pathlib.Path(split_dir)
    for name in _candidates(mix_dirname):
        if (split_dir / name).is_dir():
            return name
    return mix_dirname
