"""Latent diffusion pipeline: VAE latent space + the cuboid-transformer UNet
denoiser, unguided DDPM sampling as a Python loop.

The chain: encode the context frame by frame (posterior mode), run the
reverse steps t = T-1 .. 0 against the full schedule, decode frame by frame.
``timesteps=k`` runs only the last k steps of the schedule (t = k-1 .. 0),
as the JAX package's ``sample`` does.
"""
from typing import Optional, Sequence

import torch
from torch import nn

from ..utils.distributions import DiagonalGaussianDistribution
from . import core
from .schedule import GaussianSchedule


class LatentDiffusion:
    """Holds the denoiser and the VAE (both ``nn.Module``s on ``device``) and
    the schedule; not itself a module."""

    def __init__(self, unet: nn.Module, vae: nn.Module, schedule: GaussianSchedule,
                 latent_shape: Sequence[int], cond_latent_shape: Optional[Sequence[int]] = None,
                 parameterization: str = "eps", scale_factor: float = 1.0,
                 clip_denoised: bool = False, decode_chunk_size: Optional[int] = None,
                 device=None):
        if parameterization not in ("eps", "x0"):
            raise ValueError(f"parameterization '{parameterization}'")
        self.device = torch.device(device if device is not None else "cpu")
        self.unet = unet
        self.vae = vae
        self.schedule = schedule.to(self.device)
        self.num_timesteps = schedule.num_timesteps
        self.latent_shape = tuple(latent_shape)
        self.cond_latent_shape = tuple(cond_latent_shape or latent_shape)
        self.parameterization = parameterization
        self.scale_factor = scale_factor
        self.clip_denoised = clip_denoised
        self.decode_chunk_size = decode_chunk_size

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor) -> torch.Tensor:
        """Pixel seq (B,T,H,W,C) -> scaled latent seq (B,T,h,w,c), posterior mode."""
        B = x.shape[0]
        moments = self.vae.encode_moments(x.reshape((-1,) + tuple(x.shape[2:])))
        z = DiagonalGaussianDistribution.from_parameters(moments).mode()
        return (self.scale_factor * z).reshape((B, -1) + tuple(z.shape[1:]))

    def cond_stage_forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.encode_first_stage(y)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Latent seq (B,T,h,w,c) -> pixel seq (B,T,H,W,C); ``decode_chunk_size``
        frames at a time when set, which bounds the decoder's activations."""
        B = z.shape[0]
        frames = (z / self.scale_factor).reshape((-1,) + tuple(z.shape[2:]))
        chunk = self.decode_chunk_size or frames.shape[0]
        dec = torch.cat([self.vae.decode(f) for f in torch.split(frames, chunk)])
        return dec.reshape((B, -1) + tuple(dec.shape[1:]))

    @torch.no_grad()
    def p_sample_step(self, z: torch.Tensor, t: int, zc: torch.Tensor, temperature: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
        t_b = torch.full((z.shape[0],), t, dtype=torch.long, device=z.device)
        model_out = self.unet(z, t_b, zc)
        mean, _, log_var, _ = core.p_mean_variance(
            self.schedule, model_out, z, t_b, parameterization=self.parameterization,
            clip_denoised=self.clip_denoised)
        if t == 0 or temperature == 0.0:
            return mean
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
        return mean + torch.exp(0.5 * log_var) * noise * temperature

    @torch.no_grad()
    def sample(self, y: torch.Tensor, x_T: Optional[torch.Tensor] = None,
               timesteps: Optional[int] = None, temperature: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forecast from context ``y`` (B, T_in, H, W, C): decoded pixels
        (B, T_out, H, W, C).
        ``generator`` (on ``self.device``) draws x_T, unless given, and the
        per-step noise."""
        y = y.to(self.device, torch.float32)
        B = y.shape[0]
        if x_T is None:
            z = torch.randn((B,) + self.latent_shape, generator=generator, device=self.device)
        else:
            z = x_T.to(self.device, torch.float32)
        zc = self.cond_stage_forward(y)
        for t in range((timesteps or self.num_timesteps) - 1, -1, -1):
            z = self.p_sample_step(z, t, zc, temperature, generator)
        return self.decode_first_stage(z)
