"""DDPM noise-schedule math: every buffer derived in float64 numpy, then
cast once to f32 tensors on the caller's device; the DDIM subsequence and
its per-step parameters."""
import math
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedules: linear / cosine / sqrt_linear / sqrt (float64 numpy)."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"schedule '{schedule}' unknown.")


@dataclass
class GaussianSchedule:
    """All DDPM-derived quantities, one (T,) tensor per field."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    lvlb_weights: torch.Tensor
    num_timesteps: int = 1000

    def to(self, device) -> "GaussianSchedule":
        return GaussianSchedule(**{
            f.name: (getattr(self, f.name).to(device) if f.name != "num_timesteps"
                     else self.num_timesteps)
            for f in fields(self)
        })


def make_gaussian_schedule(
    beta_schedule: str = "linear",
    timesteps: int = 1000,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
    given_betas: Optional[Sequence[float]] = None,
    v_posterior: float = 0.0,
    parameterization: str = "eps",
    device=None,
) -> GaussianSchedule:
    """Derive every schedule buffer in float64 numpy, then cast once to f32."""
    if given_betas is not None:
        betas = np.asarray(given_betas, dtype=np.float64)
    else:
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                   linear_end=linear_end, cosine_s=cosine_s)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    (num_timesteps,) = betas.shape
    posterior_variance = (
        (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        + v_posterior * betas
    )
    if parameterization == "eps":
        # posterior_variance[0] == 0 makes lvlb[0] inf; it is overwritten below
        with np.errstate(divide="ignore"):
            lvlb_weights = betas**2 / (2 * posterior_variance * alphas * (1 - alphas_cumprod))
    elif parameterization == "x0":
        lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
    else:
        raise NotImplementedError(f"parameterization '{parameterization}'")
    lvlb_weights = lvlb_weights.copy()
    lvlb_weights[0] = lvlb_weights[1]
    if np.isnan(lvlb_weights).any():
        raise ValueError("lvlb_weights has NaN")

    def cast(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return GaussianSchedule(
        betas=cast(betas),
        alphas_cumprod=cast(alphas_cumprod),
        alphas_cumprod_prev=cast(alphas_cumprod_prev),
        sqrt_alphas_cumprod=cast(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=cast(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=cast(np.log(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=cast(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=cast(np.sqrt(1.0 / alphas_cumprod - 1)),
        posterior_variance=cast(posterior_variance),
        posterior_log_variance_clipped=cast(np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=cast(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=cast((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        lvlb_weights=cast(lvlb_weights),
        num_timesteps=int(num_timesteps),
    )


def make_ddim_timesteps(ddim_discr_method: str, num_ddim_timesteps: int,
                        num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subsequence, offset by +1 as in the reference."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps)) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(f"unknown ddim discretization '{ddim_discr_method}'")
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float):
    """Per-step (sigma, alpha, alpha_prev) for DDIM, float64 numpy."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def extract(a: torch.Tensor, t: torch.Tensor, ndim: int, batch_axis: int = 0) -> torch.Tensor:
    """Gather schedule values at timesteps ``t`` (B,) and reshape to broadcast
    against an ``ndim``-rank tensor whose batch axis is ``batch_axis``."""
    shape = [1] * ndim
    shape[batch_axis] = t.shape[0]
    return a[t].reshape(shape)
