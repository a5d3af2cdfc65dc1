"""Training losses (counterpart of ``losses/``)."""

from .pit import pairwise_pit_costs, pit_loss, pit_si_sdr_loss

__all__ = ["pairwise_pit_costs", "pit_loss", "pit_si_sdr_loss"]
