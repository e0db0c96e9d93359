"""DDPM math on latents, the reverse step and the training loss: plain tensor
functions, the schedule passed in."""
from typing import Dict, Tuple

import torch

from .schedule import GaussianSchedule, extract


def q_sample(schedule: GaussianSchedule, x_start, t, noise, batch_axis: int = 0):
    """Forward diffusion: blend clean latents with noise at step t."""
    nd = x_start.ndim
    return (extract(schedule.sqrt_alphas_cumprod, t, nd, batch_axis) * x_start
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, nd, batch_axis) * noise)


def predict_start_from_noise(schedule: GaussianSchedule, x_t, t, noise, batch_axis: int = 0):
    nd = x_t.ndim
    return (extract(schedule.sqrt_recip_alphas_cumprod, t, nd, batch_axis) * x_t
            - extract(schedule.sqrt_recipm1_alphas_cumprod, t, nd, batch_axis) * noise)


def q_posterior(schedule: GaussianSchedule, x_start, x_t, t, batch_axis: int = 0):
    """Posterior q(x_{t-1} | x_t, x_0) -> (mean, variance, log_variance)."""
    nd = x_t.ndim
    mean = (extract(schedule.posterior_mean_coef1, t, nd, batch_axis) * x_start
            + extract(schedule.posterior_mean_coef2, t, nd, batch_axis) * x_t)
    variance = extract(schedule.posterior_variance, t, nd, batch_axis)
    log_variance = extract(schedule.posterior_log_variance_clipped, t, nd, batch_axis)
    return mean, variance, log_variance


def p_mean_variance(schedule: GaussianSchedule, model_out, zt, t,
                    parameterization: str = "eps", clip_denoised: bool = False,
                    batch_axis: int = 0):
    """Model posterior p(z_{t-1} | z_t) from the denoiser output."""
    if parameterization == "eps":
        z_recon = predict_start_from_noise(schedule, zt, t, model_out, batch_axis)
    elif parameterization == "x0":
        z_recon = model_out
    else:
        raise NotImplementedError(parameterization)
    if clip_denoised:
        z_recon = torch.clamp(z_recon, -1.0, 1.0)
    mean, variance, log_variance = q_posterior(schedule, z_recon, zt, t, batch_axis)
    return mean, variance, log_variance, z_recon


def diffusion_loss(schedule: GaussianSchedule, model_output, x_start, noise, t, logvar,
                   parameterization: str = "eps", loss_type: str = "l2",
                   l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0,
                   learn_logvar: bool = False, batch_axis: int = 0,
                   prefix: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-sample simple loss, weighted per t by the learned ``logvar``, plus
    the ELBO term weighted by ``lvlb_weights``; returns the loss and the
    ``loss_dict`` (``{prefix}/loss_simple``, ``loss_gamma``, ``loss_vlb``,
    ``loss`` and ``logvar``)."""
    target = noise if parameterization == "eps" else x_start
    mean_axes = tuple(i for i in range(model_output.ndim) if i != batch_axis)
    if loss_type == "l2":
        loss_elem = (model_output - target).square()
    elif loss_type == "l1":
        loss_elem = (model_output - target).abs()
    else:
        raise NotImplementedError(loss_type)
    loss_simple = loss_elem.mean(dim=mean_axes)  # (B,)

    loss_dict = {f"{prefix}/loss_simple": loss_simple.mean()}
    logvar_t = logvar[t]
    loss = loss_simple / torch.exp(logvar_t) + logvar_t
    if learn_logvar:
        loss_dict[f"{prefix}/loss_gamma"] = loss.mean()
        loss_dict["logvar"] = logvar.mean()
    loss = l_simple_weight * loss.mean()

    loss_vlb = (schedule.lvlb_weights[t] * loss_simple).mean()
    loss_dict[f"{prefix}/loss_vlb"] = loss_vlb
    loss = loss + original_elbo_weight * loss_vlb
    loss_dict[f"{prefix}/loss"] = loss
    return loss, loss_dict
