"""Diagonal Gaussian posterior of the VAE encoder.

Channel-last: ``parameters`` is (..., 2*C) with mean and logvar split on the
last axis.  Forecasting takes the posterior mode; training samples it, and
the VAE-GAN loss takes its ``kl``.
"""
import math
from dataclasses import dataclass
from typing import Optional, Sequence

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

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """mean + std * N(0, 1); ``generator`` lies on the mean's device."""
        noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                            dtype=self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None,
           reduce_axes: Sequence[int] = (1, 2, 3)) -> torch.Tensor:
        """KL(self || other), or against N(0, 1) without ``other``, summed over
        ``reduce_axes``: (B,) for NHWC posteriors."""
        dims = tuple(reduce_axes)
        if other is None:
            return 0.5 * torch.sum(self.mean.square() + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean).square() / other.var
                               + self.var / other.var - 1.0 - self.logvar + other.logvar,
                               dim=dims)

    def nll(self, sample: torch.Tensor, reduce_axes: Sequence[int] = (1, 2, 3)) -> torch.Tensor:
        """Negative log-likelihood of ``sample``, summed over ``reduce_axes``."""
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + self.logvar
                               + (sample - self.mean).square() / self.var,
                               dim=tuple(reduce_axes))


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
