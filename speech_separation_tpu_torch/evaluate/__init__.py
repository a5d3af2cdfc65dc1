"""Directory-level separation scoring (counterpart of ``evaluate/``)."""

from .evaluate import (
    eval_sdr,
    eval_si_sdr,
    eval_si_sdri,
    evaluate_directory,
    score_pair,
)

__all__ = ["eval_sdr", "eval_si_sdr", "eval_si_sdri", "evaluate_directory", "score_pair"]
