"""Latent diffusion pipeline: VAE latent space + the cuboid-transformer UNet
denoiser, DDPM or DDIM sampling, optionally steered by knowledge alignment,
and the training loss.

The chain: encode the context frame by frame (posterior mode), run the
reverse steps, decode frame by frame.  DDPM runs t = T-1 .. 0 against the
full schedule; ``timesteps=k`` runs only the last k steps (t = k-1 .. 0), as
the JAX package's ``sample`` does.  DDIM runs ``ddim_steps`` steps of the
uniform subsequence of the first ``timesteps or T`` steps.  With
``use_alignment`` each guided step shifts the DDPM mean (or the DDIM eps)
by the alignment gradient; ``guidance_every_k=k`` guides only the steps with
t % k == 0 (DDPM) or index % k == 0 (DDIM), the shift scaled by k.

A step reads t (or the DDIM index), its noise and the latent from static
buffers and gathers the schedule's values on the device, so that one
captured CUDA graph serves every step of its kind: on the card each step
replays one (``graphs.py``, cached per static key as the JAX package caches
its compiled chain).  On the CPU the same steps run eagerly: the chain's
plain version.  The host draws each step's noise from the caller's
generator into its buffer, where and in the order the eager chain draws it.

``compute_dtype`` (float32, bfloat16 or float16) is the JAX package's: x_T
and the context latent are rounded to it; each step runs the denoiser as
flax promotes (``utils.precision.Promoted``), in ``promote(carry dtype,
parameter dtype)``: f32 parameters widen a bf16 carry, bf16 parameters
(``cast_to_bf16``) on a bf16 carry give a bf16 network, and on an f32 carry
an f32 network on a copy of the bf16-rounded weights.  The step's schedule
math is f32, from the network's output and the carry widened, as JAX's
promotes against its f32 schedule, and its result is rounded to the carry's
dtype; the step noise is drawn in the carry's dtype, the inpainting noise in
f32.  The static buffers take the dtype, the graph key carries it and the
models' parameter dtypes, and the latent output and intermediates come back
in it.  ``first_stage_dtype`` names the encode's dtype (a copy of the
encoder's parameters in that dtype where it differs from theirs: f32 on
bf16 parameters is their promotion) and the moments come back f32; the
decode runs in ``promote(latent dtype, VAE parameter dtype)`` and returns
that dtype.

Several ranks (``mesh``, a ``parallel.DataMesh``; the JAX package's
``shard_map`` chain, ``prediff_tpu/diffusion/latent_diffusion.py:392-552``):
every rank is called with the whole batch and runs its rows of it through
the encode, the steps and the decode, and the decoded output (and the
intermediates) are all-gathered, so every rank returns the whole batch, the
same bits on each.  Every draw is the whole batch's, of which a rank keeps its
rows: x_T, each step's noise and the mask's noise, from a generator whose
state every rank first takes from the mesh's first rank (a broadcast), so a
sharded chain draws what one process draws.  Guidance sums the energy over
the ranks (``knowledge_alignment.py``).  ``avg_x_gt``, ``mask`` and ``x0``
with the batch's leading axis are cut to the rank's rows; a leading axis of 1
broadcasts.  A batch the mesh does not divide runs unsharded on every rank
(JAX's rule), each computing and returning the whole batch, from the first
rank's generator state too.  A mesh of one rank runs the sharded chain,
whose rows are the whole batch and whose collectives are the identity: the
unsharded bits.  The mesh (its size, this
rank's shard, its backend) and the guided steps' route are in the graph key:
unguided steps replay graphs on any backend (their only collective, the
gather, follows the chain); a guided step all-reduces inside the step, which
a graph captures on NCCL (the generator's broadcast before the chain makes
the communicator first) and which gloo cannot capture, so on a gloo mesh the
guided steps run eagerly, on the same kernels (route ``"eager"``).  A
capture that fails raises.

Training: the frozen VAE encodes the target (posterior sample) and the
context (mode) under ``no_grad``, t and the noise are drawn from the caller's
generator, and :meth:`LatentDiffusion.p_losses` weighs the denoiser's error
(:func:`core.diffusion_loss`).  ``dropout_seed`` is the step's dropout stream
(the JAX loss's ``rng_drop``): it reaches the denoiser's forward, which uses
it in training mode only.  On several ranks (``mesh``) every draw of the loss
is the rank's rows of the global batch's draws, and the masks its rows of
the one-process masks (``dropout_first_row``).
"""
import contextlib
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.vae import FirstStageEncoder
from ..ops.dropout import as_seed
from ..parallel.mesh import (DataMesh, batch_rows, gather_batch, local_batch_slice,
                             sync_generator)
from ..utils.device import resolve_device
from ..utils.distributions import latents_from_moments_seq, randint_rows, randn_rows
from ..utils.precision import LowCopy, Promoted, dtype_name, param_dtype, resolve_dtype
from . import core
from .graphs import StepBuffers, StepGraphCache, StepGraphs
from .knowledge_alignment import KnowledgeAlignment
from .schedule import GaussianSchedule, make_ddim_sampling_parameters, make_ddim_timesteps


@dataclass
class ChainPlan:
    """The static part of a chain, what its captured steps bake in: per
    step in chain order the value of the t buffer (DDPM t, or DDIM index),
    whether it is guided and whether it draws its noise; the segments'
    lengths; whether a step adds noise at all; the DDIM schedule as device
    tensors (``ts``, ``sqrt_a``, ``sqrt_1ma``, ``sqrt_a_prev``, ``dir_coef``,
    ``sigma``, computed in f32 on the host); the mesh the guidance energy is
    summed over, and whether guided steps run eagerly (a gloo mesh)."""
    sampler: str
    values: np.ndarray
    guided: np.ndarray
    draws: np.ndarray
    segments: List[int]
    temperature: float
    noisy: bool
    guidance_every_k: int
    use_alignment: bool
    use_mask: bool
    clip_x0: bool
    ddim: Optional[Dict[str, torch.Tensor]]
    mesh: Optional[DataMesh] = None
    eager_guided: bool = False


class LatentDiffusion:
    """Holds the denoiser and the VAE (both ``nn.Module``s on ``device``),
    the schedule and, for guided sampling, the knowledge alignment; not
    itself a module.  ``device=None`` means the card, as at every entry point
    (``utils.device.resolve_device``: raises without one); ``"cpu"`` runs the
    plain versions.  ``first_stage_dtype`` names the encoder's compute dtype
    (``"auto"``: float32, the JAX package's resolution off a TPU)."""

    def __init__(self, unet: nn.Module, vae: nn.Module, schedule: GaussianSchedule,
                 latent_shape: Sequence[int], cond_latent_shape: Optional[Sequence[int]] = None,
                 parameterization: str = "eps", scale_factor: float = 1.0,
                 clip_denoised: bool = False, decode_chunk_size: Optional[int] = None,
                 alignment: Optional[KnowledgeAlignment] = None, device=None,
                 loss_type: str = "l2", l_simple_weight: float = 1.0,
                 original_elbo_weight: float = 0.0, learn_logvar: bool = False,
                 logvar_init: float = 0.0, log_every_t: int = 100,
                 first_stage_dtype="auto"):
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
        self.log_every_t = log_every_t
        self.first_stage_dtype = resolve_dtype(first_stage_dtype, "first_stage_dtype")
        self._unet, self._vae = Promoted(unet), Promoted(vae)
        # the JAX package casts the parameters to a first_stage_dtype other
        # than f32, and f32 frames promote narrower ones to f32: the encode
        # runs in first_stage_dtype either way
        self._encoder = (None if self.first_stage_dtype == param_dtype(vae)
                         else LowCopy(FirstStageEncoder(vae), self.first_stage_dtype))
        self.graphs = StepGraphCache(self._graph_modules)
        self._plain = False

    def _graph_modules(self):
        """The modules whose parameters and buffers the captured steps read
        (the UNet's copies in a promoted dtype and the alignment net's in
        the guidance dtype too, once made)."""
        return ([self.unet] + self._unet.copies()
                + (self.alignment.tracked() if self.alignment is not None else []))

    def _denoise(self, z: torch.Tensor, t_b: torch.Tensor, zc: torch.Tensor) -> torch.Tensor:
        """The denoiser as flax promotes: on z and zc in ``promote(carry dtype,
        parameter dtype)``, on its copy in that dtype where its parameters are
        narrower; the output widened to f32 for the schedule math."""
        net = self._unet.for_input(z.dtype)
        dtype = param_dtype(net)
        return net(z.to(dtype), t_b, zc.to(dtype)).float()

    @torch.no_grad()
    def first_stage_moments(self, frames: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) frames -> (n, h, w, 2c) f32 encoder moments; the VAE is
        frozen.  The frames go in ``first_stage_dtype``, on a copy of the
        encoder's parameters in it (one per parameter version) where theirs
        differ."""
        frames = frames.to(self.first_stage_dtype)
        if self._encoder is None:
            return self.vae.encode_moments(frames).float()
        return self._encoder.get()(frames).float()

    def latents_from_moments(self, moments: torch.Tensor,
                             generator: Optional[torch.Generator] = None,
                             sample_posterior: bool = False,
                             rows: Optional[Tuple[int, int]] = None,
                             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Encoder moments (B,T,h,w,2c) -> scaled latent seq (B,T,h,w,c), the
        tail of :meth:`encode_first_stage`; ``rows`` (first, total): the
        posterior's noise is those rows of the global batch's draw; ``eps``:
        that noise drawn before."""
        return latents_from_moments_seq(moments, generator=generator,
                                        sample_posterior=sample_posterior,
                                        scale_factor=self.scale_factor, rows=rows, eps=eps)

    @torch.no_grad()
    def encode_first_stage(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                           sample_posterior: bool = False,
                           rows: Optional[Tuple[int, int]] = None,
                           eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Pixel seq (B,T,H,W,C) -> scaled latent seq (B,T,h,w,c).  Training
        samples the posterior (from ``generator``, or the noise ``eps``;
        ``rows`` as :meth:`latents_from_moments`); conditioning takes the mode."""
        B = x.shape[0]
        moments = self.first_stage_moments(x.reshape((-1,) + tuple(x.shape[2:])))
        return self.latents_from_moments(moments.reshape((B, -1) + tuple(moments.shape[1:])),
                                         generator, sample_posterior, rows, eps)

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
                 dropout_seed=None, dropout_first_row: int = 0):
        """Noise ``z_start`` to step ``t`` with ``noise``, denoise, weigh:
        ``(loss, loss_dict)``.  ``unet_params`` (name -> tensor) runs the
        denoiser with other weights than its own, such as the EMA shadow.
        ``dropout_seed`` (an integer or a device seed, ``ops/dropout.py``)
        seeds the denoiser's dropout masks when it is in training mode with a
        rate above 0 (it raises without one);
        ``dropout_first_row`` is z_start's first row in the global batch (a
        rank's), from which the masks are drawn."""
        z_noisy = core.q_sample(self.schedule, z_start, t, noise)
        kwargs = {} if dropout_seed is None else {"dropout_seed": as_seed(dropout_seed),
                                                  "dropout_first_row": int(dropout_first_row)}
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

    def training_draw_shapes(self, batch: int) -> Tuple[tuple, tuple, tuple]:
        """The shapes of the posterior's noise (batch * T, h, w, c), t (batch,)
        and the noise (batch, T, h, w, c) of a training loss."""
        T, h, w, c = self.latent_shape
        return (batch * T, h, w, c), (batch,), (batch, T, h, w, c)

    def training_draws(self, generator: Optional[torch.Generator], batch: int,
                       out: Tuple[torch.Tensor, ...],
                       rows: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, ...]:
        """What a training loss draws from ``generator``, in its order, for a
        batch of ``batch`` rows, into the buffers ``out`` (shaped as
        :meth:`training_draw_shapes` of ``batch``; their values are the draws'
        bits): the posterior's noise, t and the noise.  ``rows`` (first,
        total; ``parallel.batch_rows``): the batch is a rank's rows of a
        global batch, and each draw is those rows of the global batch's, as
        :meth:`training_loss` with a mesh draws them."""
        eps_shape, t_shape, noise_shape = self.training_draw_shapes(batch)
        T = self.latent_shape[0]
        eps = randn_rows(eps_shape, generator, self.device, torch.float32,
                         None if rows is None else (rows[0] * T, rows[1] * T))
        t = randint_rows(self.num_timesteps, t_shape[0], generator, self.device, rows)
        noise = randn_rows(noise_shape, generator, self.device, torch.float32, rows)
        for buf, v in zip(out, (eps, t, noise)):
            buf.copy_(v)
        return out

    def _draw_and_weigh(self, logvar, z, zc, generator, prefix, unet_params, dropout_seed,
                        rows=None, draws=None):
        if draws is not None:
            t, noise = draws[1], draws[2]
        else:
            t = randint_rows(self.num_timesteps, z.shape[0], generator, self.device, rows)
            noise = randn_rows(z.shape, generator, self.device, z.dtype, rows)
        return self.p_losses(logvar, z, zc, t, noise, prefix=prefix, unet_params=unet_params,
                             dropout_seed=dropout_seed,
                             dropout_first_row=0 if rows is None else rows[0])

    def training_loss(self, logvar: torch.Tensor, generator: Optional[torch.Generator],
                      x: torch.Tensor, y: torch.Tensor, prefix: str = "train",
                      unet_params: Optional[Dict[str, torch.Tensor]] = None,
                      dropout_seed=None, mesh: Optional[DataMesh] = None, draws=None):
        """The full forward: encode the target ``x`` (posterior sample) and the
        context ``y`` (mode), draw t and the noise from ``generator`` (on
        ``self.device``), denoise (with the dropout masks of ``dropout_seed``,
        an integer or a device seed, in training mode), weigh.  ``mesh``: x
        and y are this rank's rows of the global batch (the same count on
        every rank), and every draw (the posterior sample, t, the noise, the
        dropout masks) is this rank's rows of the global batch's, as the JAX
        step draws them for the whole batch; ``generator`` must be in the same
        state on every rank.  ``draws``: :meth:`training_draws`' three tensors
        (on a mesh the rank's rows), drawn before; then nothing is drawn here."""
        rows = batch_rows(x.shape[0], mesh)
        z = self.encode_first_stage(x.to(self.device, torch.float32), generator,
                                    sample_posterior=True, rows=rows,
                                    eps=None if draws is None else draws[0])
        zc = self.cond_stage_forward(y.to(self.device, torch.float32))
        return self._draw_and_weigh(logvar, z, zc, generator, prefix, unet_params, dropout_seed,
                                    rows, draws)

    def training_loss_from_moments(self, logvar: torch.Tensor,
                                   generator: Optional[torch.Generator], mx: torch.Tensor,
                                   my: torch.Tensor, prefix: str = "train",
                                   unet_params: Optional[Dict[str, torch.Tensor]] = None,
                                   dropout_seed=None, mesh: Optional[DataMesh] = None,
                                   draws=None):
        """:meth:`training_loss` fed from first-stage moments of the target
        (``mx``) and the context (``my``) instead of pixels; the draws are made
        in the same order, so ``mx = encode_moments(x)`` gives the same loss."""
        rows = batch_rows(mx.shape[0], mesh)
        z = self.latents_from_moments(mx.to(self.device), generator, sample_posterior=True,
                                      rows=rows, eps=None if draws is None else draws[0])
        zc = self.latents_from_moments(my.to(self.device), sample_posterior=False)
        return self._draw_and_weigh(logvar, z, zc, generator, prefix, unet_params, dropout_seed,
                                    rows, draws)

    @torch.no_grad()
    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Latent seq (B,T,h,w,c) -> pixel seq (B,T,H,W,C); ``decode_chunk_size``
        frames at a time when set, which bounds the decoder's activations.
        The VAE runs in ``promote(z dtype, its parameter dtype)``, which the
        output takes (on its copy in that dtype where its parameters are
        narrower), as flax promotes."""
        B = z.shape[0]
        # a bf16 latent is divided in bf16, then promoted with the VAE, as in JAX
        frames = (z / self.scale_factor).reshape((-1,) + tuple(z.shape[2:]))
        chunk = self.decode_chunk_size or frames.shape[0]
        vae = self._vae.for_input(z.dtype)
        dtype = param_dtype(vae)
        dec = torch.cat([vae.decode(f.to(dtype)) for f in torch.split(frames, chunk)])
        return dec.reshape((B, -1) + tuple(dec.shape[1:]))


    # ------------------------------------------------------------------ #
    # sampling
    # ------------------------------------------------------------------ #
    def ddim_schedule(self, ddim_steps: int, total_T: int, eta: float):
        """(timesteps, sigmas, alphas, alphas_prev) of the DDIM chain as numpy
        arrays, the parameters in f32; the timesteps clipped to the schedule,
        as the JAX package does."""
        ts = np.clip(make_ddim_timesteps("uniform", ddim_steps, total_T), 0, total_T - 1)
        alphacums = self.schedule.alphas_cumprod.cpu().numpy().astype(np.float64)
        params = make_ddim_sampling_parameters(alphacums, ts, eta)
        return (ts.astype(np.int64),) + tuple(np.asarray(a, np.float32) for a in params)

    def _chain_plan(self, sampler: str, total_T: int, ddim_steps: Optional[int], ddim_eta: float,
                    ddim_clip_x0: bool, temperature: float, use_alignment: bool,
                    guidance_every_k: int, use_mask: bool, num_segments: int,
                    mesh: Optional[DataMesh] = None) -> ChainPlan:
        if sampler == "ddpm":
            values = np.arange(total_T - 1, -1, -1)
            draws = (values > 0) & (temperature != 0.0)
            noisy, ddim = temperature != 0.0, None
        elif sampler == "ddim":
            if not ddim_steps:
                raise ValueError("sampler 'ddim' needs ddim_steps")
            ts, sigmas, alphas, alphas_prev = self.ddim_schedule(ddim_steps, total_T, ddim_eta)
            values = np.arange(len(ts) - 1, -1, -1)
            draws = (sigmas[values] != 0.0) & (temperature != 0.0)
            noisy = bool(draws.any())
            one = np.float32(1.0)
            tables = dict(ts=ts, sqrt_a=np.sqrt(alphas), sqrt_1ma=np.sqrt(one - alphas),
                          sqrt_a_prev=np.sqrt(alphas_prev), sigma=sigmas,
                          dir_coef=np.sqrt(np.maximum(one - alphas_prev - sigmas * sigmas,
                                                      np.float32(0.0))))
            ddim = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                    for k, v in tables.items()}
        else:
            raise NotImplementedError(f"sampler '{sampler}'")
        k = int(guidance_every_k)
        guided = np.full(len(values), bool(use_alignment)) if k <= 1 else (
            bool(use_alignment) & (values % k == 0))
        return ChainPlan(sampler=sampler, values=values, guided=guided, draws=draws,
                         segments=[len(s) for s in np.array_split(values, num_segments)],
                         temperature=float(temperature), noisy=noisy, guidance_every_k=k,
                         use_alignment=bool(use_alignment), use_mask=use_mask,
                         clip_x0=bool(ddim_clip_x0), ddim=ddim, mesh=mesh,
                         eager_guided=self._eager_guided(mesh))

    @staticmethod
    def _buffers(plan: ChainPlan, z, zc, y, avg_x_gt, mask, x0, rows: Optional[slice] = None,
                 batch: Optional[int] = None) -> StepBuffers:
        """New buffers holding copies of a chain's inputs; the mask and x0
        broadcast to the latent's shape.  z, zc and the step noise in the
        chain's dtype, the mask's noise in f32.  On a mesh the inputs are
        the rank's ``rows`` of ``batch``, and the noise buffers views of
        those rows of the whole batch's draws."""
        def copy(t):
            return None if t is None else t.clone()

        def drawn(dtype):
            if rows is None:
                buf = torch.zeros_like(z, dtype=dtype)
                return buf, buf
            whole = torch.zeros((batch,) + tuple(z.shape[1:]), dtype=dtype, device=z.device)
            return whole[rows], whole

        noise, noise_all = drawn(z.dtype) if plan.noisy else (None, None)
        noise2, noise2_all = drawn(torch.float32) if plan.use_mask else (None, None)
        return StepBuffers(
            z=z.clone(), t=torch.zeros((z.shape[0],), dtype=torch.long, device=z.device),
            noise=noise, noise2=noise2, zc=zc.clone(), y=copy(y), avg_x_gt=copy(avg_x_gt),
            mask=None if mask is None else torch.broadcast_to(mask, z.shape).clone(),
            x0=None if x0 is None else torch.broadcast_to(x0, z.shape).clone(),
            noise_all=noise_all, noise2_all=noise2_all)

    @staticmethod
    def _load(bufs: StepBuffers, z, zc, y, avg_x_gt, mask, x0) -> None:
        """A chain's inputs into buffers of the same key."""
        for buf, t in ((bufs.z, z), (bufs.zc, zc), (bufs.y, y), (bufs.avg_x_gt, avg_x_gt),
                       (bufs.mask, mask), (bufs.x0, x0)):
            if buf is not None:
                buf.copy_(t)

    def _draw(self, buf: torch.Tensor, generator: Optional[torch.Generator]) -> None:
        """Standard normal noise into ``buf`` from ``generator``: the values
        ``torch.randn`` of its shape would draw."""
        buf.normal_(generator=generator)

    def _shift(self, z, t_b, zc, y, avg_x_gt, mesh: Optional[DataMesh] = None) -> torch.Tensor:
        return self.alignment.get_mean_shift(z, t_b, avg_x_gt, zc=zc, y=y, mesh=mesh)

    def _ddpm_update(self, s: StepBuffers, plan: ChainPlan, guided: bool) -> torch.Tensor:
        z, t_b = s.z, s.t
        zf = z.float()   # the schedule math in f32, as JAX's promotes against its schedule
        model_out = self._denoise(z, t_b, s.zc)
        mean, _, log_var, _ = core.p_mean_variance(
            self.schedule, model_out, zf, t_b, parameterization=self.parameterization,
            clip_denoised=self.clip_denoised)
        if guided:
            shift = self._shift(z, t_b, s.zc, s.y, s.avg_x_gt, plan.mesh)
            k = plan.guidance_every_k
            mean = mean - torch.exp(0.5 * log_var) * (shift if k <= 1 else float(k) * shift)
        if plan.noisy:   # the JAX body's ``nonzero``: no noise at t = 0
            nonzero = (t_b > 0).to(z.dtype).reshape((-1,) + (1,) * (z.ndim - 1))
            mean = mean + nonzero * torch.exp(0.5 * log_var) * (s.noise * plan.temperature)
        if plan.use_mask:
            z_orig = core.q_sample(self.schedule, s.x0, t_b, s.noise2)
            mean = z_orig * s.mask + (1.0 - s.mask) * mean
        return mean

    def _ddim_update(self, s: StepBuffers, plan: ChainPlan, guided: bool) -> torch.Tensor:
        """The DDIM update; like the JAX package's ``ddim_step`` it ignores
        the inpainting mask."""
        z, idx = s.z, s.t
        shape = (-1,) + (1,) * (z.ndim - 1)

        def at(name):
            return plan.ddim[name][idx].reshape(shape)

        t_b = plan.ddim["ts"][idx]
        model_out = self._denoise(z, t_b, s.zc)
        carry, z = z, z.float()   # the schedule math in f32, as JAX's promotes against it
        sqrt_a, sqrt_1ma = at("sqrt_a"), at("sqrt_1ma")
        if self.parameterization == "eps":
            eps = model_out
            x0_pred = (z - sqrt_1ma * eps) / sqrt_a
        else:
            x0_pred = model_out
            eps = (z - sqrt_a * x0_pred) / sqrt_1ma
        if plan.clip_x0 or self.clip_denoised:
            x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
        if guided:
            shift = self._shift(carry, t_b, s.zc, s.y, s.avg_x_gt, plan.mesh)
            eps = eps + sqrt_1ma * (float(max(plan.guidance_every_k, 1)) * shift)
        if plan.use_alignment:   # on every step of a guided chain, as the JAX body does
            x0_pred = (z - sqrt_1ma * eps) / sqrt_a
        out = at("sqrt_a_prev") * x0_pred + at("dir_coef") * eps
        if plan.noisy:
            out = out + at("sigma") * (s.noise * plan.temperature)
        return out

    def _reverse_step(self, s: StepBuffers, plan: ChainPlan, guided: bool) -> None:
        """One reverse step on the buffers: what a graph captures.  Every
        value that changes between steps is read from ``s`` on the device."""
        update = self._ddpm_update if plan.sampler == "ddpm" else self._ddim_update
        s.z.copy_(update(s, plan, guided))

    def _chain(self, plan: ChainPlan, bufs: StepBuffers, generator,
               entry: Optional[StepGraphs]) -> list:
        """The steps of ``plan``, each by replay of its captured graph in
        ``entry`` (eagerly without one, and a guided step of a plan whose
        guided steps run eagerly); the latent at each segment's end."""
        ends, start = [], 0
        for length in plan.segments:
            for i in range(start, start + length):
                bufs.t.fill_(int(plan.values[i]))
                if plan.draws[i]:
                    self._draw(bufs.noise_all, generator)
                if plan.use_mask:
                    self._draw(bufs.noise2_all, generator)
                guided = bool(plan.guided[i])
                if entry is None or (guided and plan.eager_guided):
                    self._reverse_step(bufs, plan, guided)
                else:
                    entry.run(guided, functools.partial(self._reverse_step, bufs, plan, guided))
            start += length
            ends.append(bufs.z.clone())
        return ends

    @staticmethod
    def _eager_guided(mesh: Optional[DataMesh]) -> bool:
        """Whether guided steps run eagerly: on a mesh whose all-reduce a
        CUDA graph cannot capture (gloo; NCCL's can)."""
        return mesh is not None and mesh.backend != "nccl"

    def _shard(self, mesh: Optional[DataMesh], batch: int,
               generator: Optional[torch.Generator]) -> Optional[DataMesh]:
        """The mesh a chain of ``batch`` runs on: None without a process group
        or when the mesh does not divide the batch (every rank then runs it
        whole, the JAX package's rule).  On any mesh with a group, sharded or
        not, ``generator`` first takes the mesh's first rank's state, so every
        rank draws the same numbers (and on NCCL this first collective makes
        the communicator before any capture)."""
        if mesh is None or not mesh.distributed:
            return None
        if mesh.device.type != self.device.type:
            raise ValueError(f"the mesh's device {mesh.device} is not the pipeline's {self.device}")
        mesh.index   # raises on a rank outside the mesh
        sync_generator(generator, self.device, mesh)
        return None if batch % mesh.size else mesh

    def _route(self) -> str:
        return "conv" if any(getattr(m, "conv_kernel", False) for model in self._graph_modules()
                             for m in model.modules()) else "default"

    def _param_dtypes(self, use_alignment: bool) -> tuple:
        """The parameter dtypes a captured step's code depends on: the
        UNet's, and the alignment net's on a guided chain."""
        models = [self.unet] + ([self.alignment.model] if use_alignment else [])
        return tuple(dtype_name(param_dtype(m)) for m in models)

    @contextlib.contextmanager
    def _plain_chain(self):
        """Run the chains in this block eagerly, as on the CPU: the captured
        chain's plain version, for the tests and ``chip_smoke.py``."""
        self._plain = True
        try:
            yield
        finally:
            self._plain = False

    @torch.no_grad()
    def sample(self, y: torch.Tensor, use_alignment: bool = False,
               alignment_kwargs: Optional[Dict[str, torch.Tensor]] = None,
               x_T: Optional[torch.Tensor] = None, timesteps: Optional[int] = None,
               mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
               return_intermediates: bool = False, return_decoded: bool = True,
               temperature: float = 1.0, sampler: str = "ddpm", ddim_steps: Optional[int] = None,
               ddim_eta: float = 0.0, ddim_clip_x0: bool = False, compute_dtype="float32",
               guidance_every_k: int = 1, generator: Optional[torch.Generator] = None,
               mesh: Optional[DataMesh] = None):
        """Forecast from context ``y`` (B, T_in, H, W, C): decoded pixels
        (B, T_out, H, W, C), or the latent z without ``return_decoded``; with
        ``return_intermediates`` also the state at the end of each of
        ``max(1, total_T // log_every_t)`` segments of the chain (decoded
        alike; None for one segment), as ``(out, intermediates)``.
        ``alignment_kwargs`` carries ``avg_x_gt`` (B, 1) for
        ``use_alignment``.  ``mask`` / ``x0`` (broadcastable to the latent)
        inpaint: after each DDPM step ``z = q_sample(x0, t)·mask + (1 -
        mask)·z``, with noise drawn after the step's own; DDIM ignores them,
        as the JAX package does.  ``generator`` (on ``self.device``) draws
        x_T, unless given, and the per-step noise.  ``compute_dtype``
        (``"float32"``, ``"bfloat16"``, ``"float16"`` or the torch dtype) is
        the carry's: see the module's note.  On the card every step replays a
        captured graph (``graphs.py``).  ``mesh``: every rank of it calls
        with the whole batch, runs its rows and returns the whole output (the
        module's note)."""
        dtype = resolve_dtype(compute_dtype, "compute_dtype")
        if (mask is None) != (x0 is None):
            raise ValueError("inpainting needs both mask and x0")
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
        mesh = self._shard(mesh, B, generator)
        rows = None if mesh is None else local_batch_slice(B, mesh.size, mesh.index)

        def mine(t, ndim):
            """The rank's rows of ``t`` where its leading axis is the batch's."""
            return t[rows] if rows is not None and t.ndim == ndim and t.shape[0] == B else t

        if x_T is None:
            z = torch.randn((B,) + self.latent_shape, generator=generator, device=self.device)
        else:
            z = x_T.to(self.device, torch.float32)
        z = mine(z, z.ndim).to(dtype)
        y = mine(y, y.ndim)
        zc = self.cond_stage_forward(y).to(dtype)
        if avg_x_gt is not None:
            avg_x_gt = mine(avg_x_gt, avg_x_gt.ndim)
        use_mask = mask is not None and sampler == "ddpm"   # DDIM ignores the mask
        if use_mask:
            mask = mine(torch.as_tensor(mask).to(self.device, torch.float32), z.ndim)
            x0 = mine(torch.as_tensor(x0).to(self.device, torch.float32), z.ndim)
        else:
            mask = x0 = None
        total_T = timesteps or self.num_timesteps
        num_segments = max(1, total_T // self.log_every_t) if return_intermediates else 1
        static = (sampler, total_T, ddim_steps, ddim_eta, ddim_clip_x0, temperature,
                  use_alignment, guidance_every_k, use_mask, num_segments, mesh)
        inputs = (z, zc, y, avg_x_gt, mask, x0)
        shard = dict(rows=rows, batch=B)
        entry = None
        self._unet.for_input(dtype)   # a promoted copy, up to date before the snapshot
        if use_alignment:   # the copy in the guidance dtype, likewise
            self.alignment.modules(dtype)
        if self.device.type == "cuda" and not self._plain:
            self.graphs.validate()
            key = ((B,) + tuple(y.shape), bool(use_alignment), timesteps, bool(return_decoded),
                   use_mask, num_segments, float(temperature), dtype_name(dtype), sampler,
                   ddim_steps, float(ddim_eta), bool(ddim_clip_x0), int(guidance_every_k),
                   self._route(), self.parameterization, self.clip_denoised,
                   (self.alignment.guide_scale, self.alignment.compute_dtype)
                   if use_alignment else None, self._param_dtypes(use_alignment),
                   None if mesh is None else mesh.key() + (
                       "eager" if self._eager_guided(mesh) else "graph",))

            def make():
                plan = self._chain_plan(*static)
                return plan, self._buffers(plan, *inputs, **shard)

            entry, new = self.graphs.entry(key, make)
            plan, bufs = entry.plan, entry.buffers
            if not new:
                self._load(bufs, *inputs)
        else:
            plan = self._chain_plan(*static)
            bufs = self._buffers(plan, *inputs, **shard)
        ends = self._chain(plan, bufs, generator, entry)
        out, inter = ends[-1], (ends if num_segments > 1 else None)
        if return_decoded:
            out = self.decode_first_stage(out)
            inter = None if inter is None else [self.decode_first_stage(i) for i in inter]
        if mesh is not None:   # every rank returns the whole batch
            out = gather_batch(out, mesh)
            inter = None if inter is None else [gather_batch(i, mesh) for i in inter]
        return (out, inter) if return_intermediates else out

    def sample_ensemble(self, y: torch.Tensor, num_samples: int, **kwargs):
        """``num_samples`` forecasts per context, the ensemble folded into the
        batch: (num_samples, B, ...), the intermediates likewise.  ``mask`` and
        ``x0`` pass through as given, as in the JAX package: they broadcast
        against the folded batch (one row serves every member).  With
        ``mesh`` the members shard across its ranks (a context's members are
        neighbours in the folded batch) and every rank returns them all."""
        B = y.shape[0]
        y_rep = torch.repeat_interleave(y, num_samples, dim=0)
        align = kwargs.pop("alignment_kwargs", None)
        if align is not None and "avg_x_gt" in align:
            align = dict(align)
            align["avg_x_gt"] = torch.repeat_interleave(
                torch.as_tensor(align["avg_x_gt"]), num_samples, dim=0)
        out = self.sample(y_rep, alignment_kwargs=align, **kwargs)

        def fold(t):
            return t.reshape((B, num_samples) + tuple(t.shape[1:])).transpose(0, 1)

        if kwargs.get("return_intermediates"):
            out, inter = out
            return fold(out), None if inter is None else [fold(i) for i in inter]
        return fold(out)
