from .schedule import GaussianSchedule, make_beta_schedule, make_gaussian_schedule, extract
from . import core
from .latent_diffusion import LatentDiffusion

__all__ = ["GaussianSchedule", "make_beta_schedule", "make_gaussian_schedule",
           "extract", "core", "LatentDiffusion"]
