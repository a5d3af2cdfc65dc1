"""Training (counterpart of ``train/``): optimizers, train state, steps,
checkpoints and the epoch loop."""

from .checkpoint import CheckpointManager
from .loop import FitResult, fit
from .optim import Adam, adam, cosine_adam, exponential_decay_adam, nadam
from .state import TrainState
from .steps import make_time_domain_steps, make_upit_waveform_steps, make_vae_steps

__all__ = [
    "Adam",
    "CheckpointManager",
    "FitResult",
    "TrainState",
    "adam",
    "cosine_adam",
    "exponential_decay_adam",
    "fit",
    "make_time_domain_steps",
    "make_upit_waveform_steps",
    "make_vae_steps",
    "nadam",
]
