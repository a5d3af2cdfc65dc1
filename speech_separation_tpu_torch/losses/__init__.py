"""Training losses (counterpart of ``losses/``)."""

from .pit import pairwise_pit_costs, pit_loss, pit_si_sdr_loss
from .sisdr import summed_squared_error

__all__ = ["pairwise_pit_costs", "pit_loss", "pit_si_sdr_loss", "summed_squared_error"]
