"""Latent diffusion pipeline: VAE latent space + the cuboid-transformer UNet
denoiser, DDPM or DDIM sampling as a Python loop, optionally steered by
knowledge alignment, and the training loss.

The chain: encode the context frame by frame (posterior mode), run the
reverse steps, decode frame by frame.  DDPM runs t = T-1 .. 0 against the
full schedule; ``timesteps=k`` runs only the last k steps (t = k-1 .. 0), as
the JAX package's ``sample`` does.  DDIM runs ``ddim_steps`` steps of the
uniform subsequence of the first ``timesteps or T`` steps.  With
``use_alignment`` each guided step shifts the DDPM mean (or the DDIM eps)
by the alignment gradient; ``guidance_every_k=k`` guides only the steps with
t % k == 0 (DDPM) or index % k == 0 (DDIM), the shift scaled by k.

Training: the frozen VAE encodes the target (posterior sample) and the
context (mode) under ``no_grad``, t and the noise are drawn from the caller's
generator, and :meth:`LatentDiffusion.p_losses` weighs the denoiser's error
(:func:`core.diffusion_loss`).  ``dropout_seed`` is the step's dropout stream
(the JAX loss's ``rng_drop``): it reaches the denoiser's forward, which uses
it in training mode only.
"""
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.distributions import latents_from_moments_seq
from . import core
from .knowledge_alignment import KnowledgeAlignment
from .schedule import GaussianSchedule, make_ddim_sampling_parameters, make_ddim_timesteps


class LatentDiffusion:
    """Holds the denoiser and the VAE (both ``nn.Module``s on ``device``),
    the schedule and, for guided sampling, the knowledge alignment; not
    itself a module.  ``device=None`` means the card, as at every entry point
    (``utils.device.resolve_device``: raises without one); ``"cpu"`` runs the
    plain versions."""

    def __init__(self, unet: nn.Module, vae: nn.Module, schedule: GaussianSchedule,
                 latent_shape: Sequence[int], cond_latent_shape: Optional[Sequence[int]] = None,
                 parameterization: str = "eps", scale_factor: float = 1.0,
                 clip_denoised: bool = False, decode_chunk_size: Optional[int] = None,
                 alignment: Optional[KnowledgeAlignment] = None, device=None,
                 loss_type: str = "l2", l_simple_weight: float = 1.0,
                 original_elbo_weight: float = 0.0, learn_logvar: bool = False,
                 logvar_init: float = 0.0):
        if parameterization not in ("eps", "x0"):
            raise ValueError(f"parameterization '{parameterization}'")
        self.device = resolve_device(device)
        self.unet = unet
        self.vae = vae
        self.alignment = alignment
        self.schedule = schedule.to(self.device)
        self.num_timesteps = schedule.num_timesteps
        self.latent_shape = tuple(latent_shape)
        self.cond_latent_shape = tuple(cond_latent_shape or latent_shape)
        self.parameterization = parameterization
        self.scale_factor = scale_factor
        self.clip_denoised = clip_denoised
        self.decode_chunk_size = decode_chunk_size
        self.loss_type = loss_type
        self.l_simple_weight = l_simple_weight
        self.original_elbo_weight = original_elbo_weight
        self.learn_logvar = learn_logvar
        self.logvar_init = logvar_init

    @torch.no_grad()
    def first_stage_moments(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) frames -> (n, h, w, 2c) f32 encoder moments; the VAE is frozen."""
        return self.vae.encode_moments(frames).float()

    def latents_from_moments(self, moments: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             sample_posterior: bool = False) -> torch.Tensor:
        """Encoder moments (B,T,h,w,2c) -> scaled latent seq (B,T,h,w,c), the
        tail of :meth:`encode_first_stage`."""
        return latents_from_moments_seq(moments, generator=generator,
                                        sample_posterior=sample_posterior,
                                        scale_factor=self.scale_factor)

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                           sample_posterior: bool = False) -> torch.Tensor:
        """Pixel seq (B,T,H,W,C) -> scaled latent seq (B,T,h,w,c).  Training
        samples the posterior (from ``generator``); conditioning takes the mode."""
        B = x.shape[0]
        moments = self.first_stage_moments(x.reshape((-1,) + tuple(x.shape[2:])))
        return self.latents_from_moments(moments.reshape((B, -1) + tuple(moments.shape[1:])),
                                         generator, sample_posterior)

    def cond_stage_forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.encode_first_stage(y, sample_posterior=False)

    def calibrate_scale_by_std(self, x: torch.Tensor,
                               generator: Optional[torch.Generator] = None) -> float:
        """Set ``scale_factor`` to 1 / std of a first batch's encodings (the
        posterior sampled when a generator is given); call once before
        training.  Returns the new factor."""
        self.scale_factor = 1.0
        z = self.encode_first_stage(x.to(self.device, torch.float32), generator,
                                    sample_posterior=generator is not None)
        self.scale_factor = 1.0 / float(z.std(unbiased=False))
        return self.scale_factor

    # ------------------------------------------------------------------ #
    # training loss
    # ------------------------------------------------------------------ #
    def init_logvar(self) -> torch.Tensor:
        return torch.full((self.num_timesteps,), float(self.logvar_init), dtype=torch.float32,
                          device=self.device)

    def p_losses(self, logvar: torch.Tensor, z_start: torch.Tensor, zc: torch.Tensor,
                 t: torch.Tensor, noise: torch.Tensor, prefix: str = "train",
                 unet_params: Optional[Dict[str, torch.Tensor]] = None,
                 dropout_seed: Optional[int] = None):
        """Noise ``z_start`` to step ``t`` with ``noise``, denoise, weigh:
        ``(loss, loss_dict)``.  ``unet_params`` (name -> tensor) runs the
        denoiser with other weights than its own, such as the EMA shadow.
        ``dropout_seed`` seeds the denoiser's dropout masks when it is in
        training mode with a rate above 0 (it raises without one)."""
        z_noisy = core.q_sample(self.schedule, z_start, t, noise)
        kwargs = {} if dropout_seed is None else {"dropout_seed": int(dropout_seed)}
        if unet_params is None:
            model_out = self.unet(z_noisy, t, zc, **kwargs)
        else:
            model_out = torch.func.functional_call(self.unet, unet_params, (z_noisy, t, zc),
                                                   kwargs)
        return core.diffusion_loss(
            self.schedule, model_out, z_start, noise, t, logvar,
            parameterization=self.parameterization, loss_type=self.loss_type,
            l_simple_weight=self.l_simple_weight,
            original_elbo_weight=self.original_elbo_weight, learn_logvar=self.learn_logvar,
            prefix=prefix)

    def _draw_and_weigh(self, logvar, z, zc, generator, prefix, unet_params, dropout_seed):
        t = torch.randint(0, self.num_timesteps, (z.shape[0],), generator=generator,
                          device=self.device)
        noise = torch.randn(z.shape, generator=generator, device=self.device, dtype=z.dtype)
        return self.p_losses(logvar, z, zc, t, noise, prefix=prefix, unet_params=unet_params,
                             dropout_seed=dropout_seed)

    def training_loss(self, logvar: torch.Tensor, generator: Optional[torch.Generator],
                      x: torch.Tensor, y: torch.Tensor, prefix: str = "train",
                      unet_params: Optional[Dict[str, torch.Tensor]] = None,
                      dropout_seed: Optional[int] = None):
        """The full forward: encode the target ``x`` (posterior sample) and the
        context ``y`` (mode), draw t and the noise from ``generator`` (on
        ``self.device``), denoise (with the dropout masks of ``dropout_seed``
        in training mode), weigh."""
        z = self.encode_first_stage(x.to(self.device, torch.float32), generator,
                                    sample_posterior=True)
        zc = self.cond_stage_forward(y.to(self.device, torch.float32))
        return self._draw_and_weigh(logvar, z, zc, generator, prefix, unet_params, dropout_seed)

    def training_loss_from_moments(self, logvar: torch.Tensor,
                                   generator: Optional[torch.Generator], mx: torch.Tensor,
                                   my: torch.Tensor, prefix: str = "train",
                                   unet_params: Optional[Dict[str, torch.Tensor]] = None,
                                   dropout_seed: Optional[int] = None):
        """:meth:`training_loss` fed from first-stage moments of the target
        (``mx``) and the context (``my``) instead of pixels; the draws are made
        in the same order, so ``mx = encode_moments(x)`` gives the same loss."""
        z = self.latents_from_moments(mx.to(self.device), generator, sample_posterior=True)
        zc = self.latents_from_moments(my.to(self.device), sample_posterior=False)
        return self._draw_and_weigh(logvar, z, zc, generator, prefix, unet_params, dropout_seed)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Latent seq (B,T,h,w,c) -> pixel seq (B,T,H,W,C); ``decode_chunk_size``
        frames at a time when set, which bounds the decoder's activations."""
        B = z.shape[0]
        frames = (z / self.scale_factor).reshape((-1,) + tuple(z.shape[2:]))
        chunk = self.decode_chunk_size or frames.shape[0]
        dec = torch.cat([self.vae.decode(f) for f in torch.split(frames, chunk)])
        return dec.reshape((B, -1) + tuple(dec.shape[1:]))

    def _shift(self, z, t_b, zc, y, avg_x_gt) -> torch.Tensor:
        return self.alignment.get_mean_shift(z, t_b, avg_x_gt, zc=zc, y=y)

    @torch.no_grad()
    def p_sample_step(self, z: torch.Tensor, t: int, zc: torch.Tensor, temperature: float,
                      generator: Optional[torch.Generator], y: Optional[torch.Tensor] = None,
                      avg_x_gt: Optional[torch.Tensor] = None,
                      guidance_every_k: int = 1) -> torch.Tensor:
        """One DDPM reverse step; guided when ``avg_x_gt`` is given."""
        t_b = torch.full((z.shape[0],), t, dtype=torch.long, device=z.device)
        model_out = self.unet(z, t_b, zc)
        mean, _, log_var, _ = core.p_mean_variance(
            self.schedule, model_out, z, t_b, parameterization=self.parameterization,
            clip_denoised=self.clip_denoised)
        if avg_x_gt is not None:
            k = int(guidance_every_k)
            if k <= 1:
                mean = mean - torch.exp(0.5 * log_var) * self._shift(z, t_b, zc, y, avg_x_gt)
            elif t % k == 0:
                shift = self._shift(z, t_b, zc, y, avg_x_gt)
                mean = mean - torch.exp(0.5 * log_var) * (float(k) * shift)
        if t == 0 or temperature == 0.0:
            return mean
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
        return mean + torch.exp(0.5 * log_var) * noise * temperature

    def ddim_schedule(self, ddim_steps: int, total_T: int, eta: float):
        """(timesteps, sigmas, alphas, alphas_prev) of the DDIM chain as numpy
        arrays, the parameters in f32; the timesteps clipped to the schedule,
        as the JAX package does."""
        ts = np.clip(make_ddim_timesteps("uniform", ddim_steps, total_T), 0, total_T - 1)
        alphacums = self.schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
        params = make_ddim_sampling_parameters(alphacums, ts, eta)
        return (ts.astype(np.int64),) + tuple(np.asarray(a, np.float32) for a in params)

    @torch.no_grad()
    def ddim_step(self, z, idx: int, ddim, zc, temperature: float,
                  generator: Optional[torch.Generator], clip_x0: bool = False, y=None,
                  avg_x_gt=None, guidance_every_k: int = 1) -> torch.Tensor:
        """DDIM step ``idx`` of the chain ``ddim`` (from :meth:`ddim_schedule`);
        guided when ``avg_x_gt`` is given, by shifting eps by
        sqrt(1 - a_t) x the alignment gradient.  The step's scalars are f32,
        computed on the host."""
        ts, sigmas, alphas, alphas_prev = ddim
        t_b = torch.full((z.shape[0],), int(ts[idx]), dtype=torch.long, device=z.device)
        model_out = self.unet(z, t_b, zc)
        one = np.float32(1.0)
        a_t, a_prev, sigma = alphas[idx], alphas_prev[idx], sigmas[idx]
        sqrt_a, sqrt_1ma = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        if self.parameterization == "eps":
            eps = model_out
            x0_pred = (z - sqrt_1ma * eps) / sqrt_a
        else:
            x0_pred = model_out
            eps = (z - sqrt_a * x0_pred) / sqrt_1ma
        if clip_x0 or self.clip_denoised:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        if avg_x_gt is not None:
            k = int(guidance_every_k)
            if k <= 1 or idx % k == 0:
                shift = self._shift(z, t_b, zc, y, avg_x_gt)
                eps = eps + sqrt_1ma * (float(max(k, 1)) * shift)
            x0_pred = (z - sqrt_1ma * eps) / sqrt_a
        dir_coef = float(np.sqrt(np.maximum(one - a_prev - sigma * sigma, np.float32(0.0))))
        out = float(np.sqrt(a_prev)) * x0_pred + dir_coef * eps
        if sigma != 0.0 and temperature != 0.0:
            noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
            out = out + float(sigma) * noise * temperature
        return out

    @torch.no_grad()
    def sample(self, y: torch.Tensor, use_alignment: bool = False,
               alignment_kwargs: Optional[Dict[str, torch.Tensor]] = None,
               sampler: str = "ddpm", ddim_steps: Optional[int] = None, ddim_eta: float = 0.0,
               ddim_clip_x0: bool = False, guidance_every_k: int = 1,
               x_T: Optional[torch.Tensor] = None, timesteps: Optional[int] = None,
               temperature: float = 1.0,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Forecast from context ``y`` (B, T_in, H, W, C): decoded pixels
        (B, T_out, H, W, C).  ``alignment_kwargs`` carries ``avg_x_gt`` (B, 1)
        for ``use_alignment``.  ``generator`` (on ``self.device``) draws x_T,
        unless given, and the per-step noise."""
        avg_x_gt = None
        if use_alignment:
            if self.alignment is None:
                raise ValueError("use_alignment needs a pipeline built with alignment")
            avg_x_gt = (alignment_kwargs or {}).get("avg_x_gt")
            if avg_x_gt is None:
                raise ValueError("use_alignment needs alignment_kwargs={'avg_x_gt': ...}")
            avg_x_gt = torch.as_tensor(avg_x_gt, dtype=torch.float32, device=self.device)
        y = y.to(self.device, torch.float32)
        B = y.shape[0]
        if x_T is None:
            z = torch.randn((B,) + self.latent_shape, generator=generator, device=self.device)
        else:
            z = x_T.to(self.device, torch.float32)
        zc = self.cond_stage_forward(y)
        guide = dict(y=y, avg_x_gt=avg_x_gt, guidance_every_k=guidance_every_k)
        total_T = timesteps or self.num_timesteps
        if sampler == "ddpm":
            for t in range(total_T - 1, -1, -1):
                z = self.p_sample_step(z, t, zc, temperature, generator, **guide)
        elif sampler == "ddim":
            if not ddim_steps:
                raise ValueError("sampler 'ddim' needs ddim_steps")
            ddim = self.ddim_schedule(ddim_steps, total_T, ddim_eta)
            for idx in range(len(ddim[0]) - 1, -1, -1):
                z = self.ddim_step(z, idx, ddim, zc, temperature, generator, ddim_clip_x0,
                                   **guide)
        else:
            raise NotImplementedError(f"sampler '{sampler}'")
        return self.decode_first_stage(z)

    def sample_ensemble(self, y: torch.Tensor, num_samples: int, **kwargs) -> torch.Tensor:
        """``num_samples`` forecasts per context, the ensemble folded into the
        batch: (num_samples, B, T_out, H, W, C)."""
        B = y.shape[0]
        y_rep = torch.repeat_interleave(y, num_samples, dim=0)
        align = kwargs.pop("alignment_kwargs", None)
        if align is not None and "avg_x_gt" in align:
            align = dict(align)
            align["avg_x_gt"] = torch.repeat_interleave(
                torch.as_tensor(align["avg_x_gt"]), num_samples, dim=0)
        out = self.sample(y_rep, alignment_kwargs=align, **kwargs)
        return out.reshape((B, num_samples) + tuple(out.shape[1:])).transpose(0, 1)
