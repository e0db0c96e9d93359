"""VAE-GAN training with two optimizers, on one device: the generator update
(L1 reconstruction under a learned logvar, KL, the adaptive adversarial
term), then the discriminator update (hinge on real and fake).

Counterpart of ``prediff_tpu/training/vae_trainer.py`` (reference
train_vae_sevirlr.py:433-475 and taming/losses/contperceptual.py).  The
step follows the JAX step:

* the posterior sample comes from a generator seeded from the caller's seed
  and the generator state's step (``step_generator``), which is also the
  step the ``disc_start`` gate reads, before its increment;
* the generator's pass through the discriminator and the adaptive weight's
  pass normalise by the batch's statistics and leave the running ones as
  they are; only the discriminator update moves them, real batch then fake;
* the adaptive weight differentiates with respect to the decoder's
  ``conv_out`` weight alone, on the detached features before it
  (``calculate_adaptive_weight``), and is computed, and logged, before
  ``disc_start`` too;
* the discriminator scores the reconstruction of the generator pass,
  detached: made with the parameters from before the generator update;
* the learned scalar ``logvar`` is a parameter of the generator state.

On the card the convolutions are cuDNN's in f32 (TF32 off) with its
deterministic algorithms (``utils.device.resolve_device``), so a step repeats
bit for bit.  ``compute_dtype="bfloat16"`` (or float16) runs the VAE's
encode and decode, forward and backward, on its parameters cast to that
dtype (``torch.func.functional_call``; the cast is differentiated, so the
gradients land on the stored f32 parameters) and on the frames and latent in
it, as the JAX step does; the moments, the reconstruction and the features
before ``conv_out`` come back in f32, so the KL, ``logvar``, the adaptive
weight (on the stored f32 ``conv_out`` kernel), LPIPS, the discriminator and
both optimizers stay f32.

Several ranks (``mesh``): every rank holds both replicated states and its
rows of the global batch of frames; the posterior sample is its rows of the
global batch's draw, the discriminator's BatchNorm takes the global batch's
statistics and moves the running ones by them (ActNorm's initialisation
likewise), the adaptive weight takes the norms of the all-reduced gradients
of both terms, and both states' gradients and the logs are all-reduced means
over the ranks, so the step is the JAX step on the whole batch.  The TPU
optimizer-layout knobs (not carried over) are refused.
"""
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vae import AutoencoderKL, FeatureDecoder, FirstStageEncoder
from ..parallel.mesh import DataMesh, all_reduce_mean, batch_rows, replicate_
from ..utils.distributions import DiagonalGaussianDistribution
from ..utils.precision import resolve_dtype
from .diffusion_trainer import reduce_loss_dict, refuse_knobs, step_generator
from .losses import (NLayerDiscriminator, calculate_adaptive_weight, discriminator_loss,
                     generator_loss)
from .optim import build_optimizer
from .train_state import EmaTrainState

_TPU_KNOBS = {"flat_update": False, "pack_small_thr": 0}


def resolve_compute_dtype(compute_dtype) -> Optional[torch.dtype]:
    """None for the f32 step (``None``, ``"float32"``, ``"f32"``, and
    ``"auto"``, which the JAX package resolves to f32 off a TPU); else the
    dtype named (``"bfloat16"`` or ``"bf16"``, ``"float16"``, or the torch
    dtype).  Anything else raises ``ValueError``."""
    if compute_dtype in (None, "f32", "auto"):
        return None
    dtype = resolve_dtype("bfloat16" if compute_dtype == "bf16" else compute_dtype,
                          "compute_dtype")
    return None if dtype == torch.float32 else dtype


def _conv2d_same(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The decoder's 3x3 ``conv_out`` on NHWC features with another kernel."""
    pad = (kernel.shape[-1] - 1) // 2
    return F.conv2d(h.permute(0, 3, 1, 2), kernel, bias, padding=pad).permute(0, 2, 3, 1)


class VAETrainer:
    def __init__(self, vae: AutoencoderKL, disc: Optional[NLayerDiscriminator] = None,
                 disc_start: int = 50001, kl_weight: float = 1e-6, disc_weight: float = 0.5,
                 disc_factor: float = 1.0, disc_loss: str = "hinge", logvar_init: float = 0.0,
                 perceptual_fn: Optional[Callable] = None, perceptual_weight: float = 0.0,
                 optim_config: Optional[Dict] = None, disc_optim_config: Optional[Dict] = None,
                 compute_dtype: Optional[str] = None, mesh: Optional[DataMesh] = None,
                 **knobs):
        refuse_knobs("VAETrainer", knobs, _TPU_KNOBS)
        self.mesh = mesh
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.vae = vae
        self._encode, self._decode = FirstStageEncoder(vae), FeatureDecoder(vae)
        self.device = next(vae.parameters()).device
        self.disc = disc or NLayerDiscriminator(
            input_nc=vae.decoder.conv_out.out_channels,
            n_layers=3).reset_parameters(torch.default_generator).to(self.device)
        self.disc_start = disc_start
        self.kl_weight = kl_weight
        self.disc_weight = disc_weight
        self.disc_factor = disc_factor
        self.disc_loss = disc_loss
        self.logvar_init = logvar_init
        self.perceptual_fn = perceptual_fn
        self.perceptual_weight = perceptual_weight
        self.optim_config = dict(optim_config or {})
        self.disc_optim_config = dict(disc_optim_config or self.optim_config)

    def create_states(self, sample_input: Optional[torch.Tensor] = None
                      ) -> Tuple[EmaTrainState, EmaTrainState, Dict[str, torch.Tensor]]:
        """``(gen_state, disc_state, disc_batch_stats)``: the generator state
        over ``"vae.<name>"`` and ``"logvar"``, the discriminator's over its
        state_dict names, and its BatchNorms' running statistics (live
        buffers, moved by ``train_step``).  ``sample_input`` (NHWC; on a mesh
        this rank's rows) initialises the ActNorms from their inputs, as
        flax's ``init`` does.  On a mesh every tensor is then the first
        rank's."""
        self.vae.train().requires_grad_(True)
        self.disc.train().requires_grad_(True)
        if sample_input is not None and self.disc.use_actnorm:
            self.disc.data_init(sample_input.to(self.device, torch.float32), self.mesh)
        gen: Dict[str, nn.Parameter] = {f"vae.{k}": p for k, p in self.vae.named_parameters()}
        gen["logvar"] = nn.Parameter(torch.tensor(float(self.logvar_init), device=self.device))
        disc = dict(self.disc.named_parameters())
        gen_state = EmaTrainState.create(
            gen, build_optimizer(list(gen.values()), **self.optim_config), use_ema=False)
        disc_state = EmaTrainState.create(
            disc, build_optimizer(list(disc.values()), **self.disc_optim_config), use_ema=False)
        batch_stats = self.disc.batch_stats()
        gen_state.replicate(self.mesh)
        disc_state.replicate(self.mesh)
        replicate_(list(batch_stats.values()), self.mesh)
        return gen_state, disc_state, batch_stats

    def _sample(self, posterior: DiagonalGaussianDistribution,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """The posterior's sample: on a mesh this rank's rows of the global
        batch's draw."""
        rows = batch_rows(posterior.mean.shape[0], self.mesh)
        return posterior.sample(generator) if rows is None else posterior.sample(generator, rows)

    def _reconstruct(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        """``(reconstruction, features before conv_out, posterior)`` of NHWC
        frames, the latent sampled from ``generator``; in ``compute_dtype``
        through the cast parameters, the outputs in f32."""
        cd = self.compute_dtype
        if cd is None:
            posterior = self.vae.encode(x)
            recon, feats = self.vae.decode_with_features(self._sample(posterior, generator))
            return recon, feats, posterior
        cast = {k: p.to(cd) for k, p in self.vae.named_parameters()}
        moments = torch.func.functional_call(
            self._encode, {k: cast[k] for k, _ in self._encode.named_parameters()}, (x.to(cd),))
        posterior = DiagonalGaussianDistribution.from_parameters(moments.float())
        recon, feats = torch.func.functional_call(
            self._decode, {k: cast[k] for k, _ in self._decode.named_parameters()},
            (self._sample(posterior, generator).to(cd),))
        return recon.float(), feats.float(), posterior

    def _generator_loss(self, logvar: torch.Tensor, x: torch.Tensor,
                        generator: Optional[torch.Generator], global_step: int):
        recon, feats, posterior = self._reconstruct(x, generator)
        logits_fake = self.disc(recon, train=True, mesh=self.mesh)
        conv_out = self.vae.decoder.conv_out
        h_sg, bias, logvar_sg = feats.detach(), conv_out.bias.detach(), logvar.detach()
        use_perceptual = self.perceptual_fn is not None and self.perceptual_weight > 0

        def nll_of_kernel(kernel):
            rec_k = _conv2d_same(h_sg, kernel, bias)
            rec = (x - rec_k).abs()
            if use_perceptual:
                rec = rec + self.perceptual_weight * self.perceptual_fn(x, rec_k)
            return torch.sum(rec / torch.exp(logvar_sg) + logvar_sg) / x.shape[0]

        def g_of_kernel(kernel):
            return -self.disc(_conv2d_same(h_sg, kernel, bias), train=True,
                              mesh=self.mesh).mean()

        d_weight = calculate_adaptive_weight(nll_of_kernel, g_of_kernel, conv_out.weight,
                                             self.disc_weight, mesh=self.mesh)
        perceptual = self.perceptual_fn(x, recon) if use_perceptual else None
        loss, log = generator_loss(
            x, recon, posterior.kl(), logvar, logits_fake, d_weight, global_step,
            self.disc_start, kl_weight=self.kl_weight, disc_factor=self.disc_factor,
            perceptual=perceptual, perceptual_weight=self.perceptual_weight)
        return loss, log, recon

    def grads(self, gen_state: EmaTrainState, disc_state: EmaTrainState,
              seed: Union[int, torch.Generator], x: torch.Tensor, reduce: bool = True):
        """The step's gradients of both states, in the order of their
        ``params``, and its logs (0-dim tensors on the device).  Neither
        gradient depends on the other update, so the JAX step's order (the
        generator's update between the two) gives the same values; the
        discriminator's passes move the running statistics.  On a mesh ``x``
        is this rank's rows and the gradients and logs are means over the
        ranks (``reduce=False``: this rank's own; the batch statistics and
        the adaptive weight are the global batch's either way)."""
        x = x.to(self.device, torch.float32)
        global_step = gen_state.step
        generator = step_generator(seed, global_step, self.device)
        g_loss, g_log, recon = self._generator_loss(gen_state.params["logvar"], x, generator,
                                                    global_step)
        g_grads = torch.autograd.grad(g_loss, list(gen_state.params.values()))

        recon_sg = recon.detach()
        logits_real = self.disc(x, train=True, update_stats=True, mesh=self.mesh)
        logits_fake = self.disc(recon_sg, train=True, update_stats=True, mesh=self.mesh)
        d_loss, d_log = discriminator_loss(logits_real, logits_fake, global_step,
                                           self.disc_start, disc_factor=self.disc_factor,
                                           disc_loss=self.disc_loss)
        d_grads = torch.autograd.grad(d_loss, list(disc_state.params.values()))
        mesh = self.mesh if reduce else None
        n_gen = len(g_grads)
        grads = all_reduce_mean(list(g_grads) + list(d_grads), mesh)
        return grads[:n_gen], grads[n_gen:], reduce_loss_dict({**g_log, **d_log}, mesh)

    def train_step(self, gen_state: EmaTrainState, disc_state: EmaTrainState,
                   batch_stats: Dict[str, torch.Tensor], seed: Union[int, torch.Generator],
                   x: torch.Tensor):
        """One step on NHWC frames ``x``: the generator update, then the
        discriminator update; ``batch_stats`` (from ``create_states``) move in
        place.  Returns ``(gen_state, disc_state, batch_stats, logs)``."""
        g_grads, d_grads, logs = self.grads(gen_state, disc_state, seed, x)
        gen_state.apply_gradients(g_grads)
        disc_state.apply_gradients(d_grads)
        return gen_state, disc_state, batch_stats, logs
