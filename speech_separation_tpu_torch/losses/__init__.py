"""Training losses (counterpart of ``losses/``)."""

from .pit import pairwise_pit_costs, pit_loss, pit_loss_packed, pit_si_sdr_loss
from .sisdr import si_sdr, si_sdr_loss, summed_squared_error

__all__ = [
    "pairwise_pit_costs",
    "pit_loss",
    "pit_loss_packed",
    "pit_si_sdr_loss",
    "si_sdr",
    "si_sdr_loss",
    "summed_squared_error",
]
