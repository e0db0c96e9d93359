"""Diagonal Gaussian posterior of the VAE encoder.

Channel-last: ``parameters`` is (..., 2*C) with mean and logvar split on the
last axis.  Forecasting takes the posterior mode; training samples it.
"""
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_parameters(cls, parameters: torch.Tensor, clip=(-30.0, 20.0)):
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        return cls(mean=mean, logvar=torch.clamp(logvar, clip[0], clip[1]))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * N(0, 1); ``generator`` lies on the mean's device."""
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean


def latents_from_moments_seq(moments: torch.Tensor, generator: Optional[torch.Generator] = None,
                             sample_posterior: bool = False,
                             scale_factor: float = 1.0) -> torch.Tensor:
    """Encoder moments (B, T, h, w, 2c) -> scaled latent seq (B, T, h, w, c):
    posterior sample (or mode) over the flattened frames, then
    ``scale_factor``: the tail of the first-stage encode, shared with
    training from cached moments."""
    B = moments.shape[0]
    frames = moments.float().reshape((-1,) + tuple(moments.shape[2:]))
    posterior = DiagonalGaussianDistribution.from_parameters(frames)
    z = posterior.sample(generator) if sample_posterior else posterior.mode()
    z = scale_factor * z
    return z.reshape((B, -1) + tuple(z.shape[1:]))
