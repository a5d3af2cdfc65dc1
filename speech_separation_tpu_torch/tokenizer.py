"""Codec tokenizer helpers (counterpart of ``tokenizer.py``): the codebook
health metrics the codec CLI reports. The rest of the JAX module (token
layouts, split encoding, the code prior) waits for a later slice."""

from __future__ import annotations

import numpy as np

__all__ = ["code_metrics"]


def code_metrics(indices: np.ndarray, num_codes: int) -> dict[str, float]:
    """Codebook health: perplexity ``exp(H(p))`` of the empirical code
    distribution and the fraction of codes used at least once."""
    counts = np.bincount(np.asarray(indices).reshape(-1), minlength=num_codes)
    total = counts.sum()
    if total == 0:
        return {"perplexity": 0.0, "usage": 0.0, "codes": 0}
    p = counts / total
    nz = p[p > 0]
    perplexity = float(np.exp(-np.sum(nz * np.log(nz))))
    return {
        "perplexity": round(perplexity, 2),
        "usage": round(float((counts > 0).mean()), 4),
        "codes": int(total),
    }
