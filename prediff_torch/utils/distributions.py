"""Diagonal Gaussian posterior of the VAE encoder.

Channel-last: ``parameters`` is (..., 2*C) with mean and logvar split on the
last axis.  The forecast path only takes the posterior mode.
"""
from dataclasses import dataclass

import torch


@dataclass
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_parameters(cls, parameters: torch.Tensor, clip=(-30.0, 20.0)):
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        return cls(mean=mean, logvar=torch.clamp(logvar, clip[0], clip[1]))

    def mode(self) -> torch.Tensor:
        return self.mean
