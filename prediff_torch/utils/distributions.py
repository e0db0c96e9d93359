"""Diagonal Gaussian posterior of the VAE encoder.

Channel-last: ``parameters`` is (..., 2*C) with mean and logvar split on the
last axis.  Forecasting takes the posterior mode; training samples it, and
the VAE-GAN loss takes its ``kl``.
"""
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def randn_rows(shape, generator: Optional[torch.Generator], device, dtype,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``torch.randn(shape)`` from ``generator``; with ``rows = (first,
    total)`` the rows ``first ..`` of the draw of ``total`` rows instead (a
    rank's rows of the global batch's draw: what one process holding the
    whole batch draws there)."""
    if rows is None:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    first, total = rows
    whole = torch.randn((total,) + tuple(shape[1:]), generator=generator, device=device,
                        dtype=dtype)
    return whole[first:first + shape[0]]


def randint_rows(high: int, n: int, generator: Optional[torch.Generator], device,
                 rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``torch.randint(0, high, (n,))`` from ``generator``, or with ``rows``
    those rows of the draw of ``total`` (as :func:`randn_rows`)."""
    if rows is None:
        return torch.randint(0, high, (n,), generator=generator, device=device)
    first, total = rows
    return torch.randint(0, high, (total,), generator=generator, device=device)[first:first + n]


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

    def sample(self, generator: Optional[torch.Generator] = None,
               rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """mean + std * N(0, 1); ``generator`` lies on the mean's device;
        ``rows`` (first, total) of the leading axis: the noise is those rows
        of the whole batch's draw (:func:`randn_rows`)."""
        noise = randn_rows(self.mean.shape, generator, self.mean.device, self.mean.dtype, rows)
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
                             sample_posterior: bool = False, scale_factor: float = 1.0,
                             rows: Optional[Tuple[int, int]] = None,
                             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder moments (B, T, h, w, 2c) -> scaled latent seq (B, T, h, w, c):
    posterior sample (or mode) over the flattened frames, then
    ``scale_factor``: the tail of the first-stage encode, shared with
    training from cached moments.  ``rows`` (first, total) of the batch:
    the sample's noise is those rows of the whole batch's draw.  ``eps``
    (B * T, h, w, c): the sample's standard normal noise, drawn before (no
    draw from ``generator``)."""
    B, T = moments.shape[:2]
    frames = moments.float().reshape((-1,) + tuple(moments.shape[2:]))
    posterior = DiagonalGaussianDistribution.from_parameters(frames)
    if not sample_posterior:
        z = posterior.mode()
    elif eps is not None:
        z = posterior.mean + posterior.std * eps
    elif rows is None:   # one process: the call as it always was
        z = posterior.sample(generator)
    else:
        z = posterior.sample(generator, (rows[0] * T, rows[1] * T))
    z = scale_factor * z
    return z.reshape((B, -1) + tuple(z.shape[1:]))
