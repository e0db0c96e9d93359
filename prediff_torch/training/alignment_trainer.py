"""Knowledge-alignment network training on one device: U(z_t, t) regressed
onto ``target_fn(x)`` (the per-frame mean intensity for SEVIR) from
q-sampled noisy latents of the frozen VAE.

Counterpart of ``prediff_tpu/training/alignment_trainer.py`` (reference
AlignmentPL, alignment_pl.py:22, forward :338).  A step runs eagerly.  Where
the JAX step splits its key four ways (encode, t, noise, dropout), the port
draws the posterior sample, t and the noise, in that order, from one
generator seeded from the caller's seed and ``state.step``
(``step_generator``), and the network's dropout masks from
``step_dropout_seed``, as ``DiffusionTrainer`` does.  ``z`` is a posterior
sample, scaled, and carries no gradient.  In
training mode each FFN and axial attention layer of the network launches its
dropout kernel (forward and all-gradients backward), ``first_proj`` its
GroupNorm+SiLU kernels and each stage's time block the whole-resblock
kernels, whose parameter gradients come from autograd of the plain version
(``ops/_build.plain_grads``), as the JAX package takes them by XLA recompute.

Several ranks (``mesh``): as ``DiffusionTrainer``, every rank holds the
replicated state and its rows of the global batch; the posterior sample, t,
the noise and the dropout masks are its rows of the global batch's draws,
and the gradients and the logged losses are all-reduced means over the
ranks (``relative_mae`` the reduced ``mae`` over the reduced ``avg_gt``, as
the JAX step computes it on the whole batch).

Refused when asked for, not carried over: the TPU knobs ``prng_impl``,
``flat_update``, ``pack_small_thr``, ``matmul_precision`` and
``conv3d_impl``.
"""
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..diffusion import core
from ..diffusion.knowledge_alignment import avg_x_objective
from ..diffusion.schedule import GaussianSchedule, make_gaussian_schedule
from ..models.alignment import NoisyCuboidTransformerEncoder
from ..models.vae import AutoencoderKL
from ..parallel.mesh import DataMesh, all_reduce_mean, batch_rows
from ..utils.distributions import latents_from_moments_seq, randint_rows, randn_rows
from .diffusion_trainer import (reduce_loss_dict, refuse_knobs, step_dropout_seed,
                                step_generator)
from .optim import build_optimizer, get_loss_fn
from .train_state import EmaTrainState, param_grads

_TPU_KNOBS = {"prng_impl": None, "flat_update": False, "pack_small_thr": 0,
              "matmul_precision": None, "conv3d_impl": None}


class AlignmentTrainer:
    def __init__(self, model: NoisyCuboidTransformerEncoder, vae: AutoencoderKL,
                 schedule: Optional[GaussianSchedule] = None, timesteps: int = 1000,
                 scale_factor: float = 1.0,
                 target_fn: Callable[[torch.Tensor], torch.Tensor] = avg_x_objective,
                 loss_type: str = "l2", optim_config: Optional[Dict] = None,
                 use_ema: bool = False, latent_inputs: bool = False,
                 mesh: Optional[DataMesh] = None, **knobs):
        refuse_knobs("AlignmentTrainer", knobs, _TPU_KNOBS)
        if any(p.requires_grad for p in vae.parameters()):
            raise ValueError("the VAE must be frozen")
        self.mesh = mesh
        self.model = model
        self.vae = vae
        self.device = next(model.parameters()).device
        self.schedule = (schedule or make_gaussian_schedule(timesteps=timesteps)).to(self.device)
        self.scale_factor = scale_factor
        self.target_fn = target_fn
        self.loss_type = loss_type
        self._loss = get_loss_fn(loss_type)
        self.optim_config = dict(optim_config or {})
        self.use_ema = use_ema
        # True: the step takes cached first-stage moments (mx, my) and the
        # cached per-frame pixel means as the target; the VAE encode drops out
        self.latent_inputs = latent_inputs

    def create_state(self) -> EmaTrainState:
        """A fresh state over the network's parameters (state_dict names),
        the network put in training mode, where its dropout rates are active."""
        self.model.train().requires_grad_(True)
        params: Dict[str, nn.Parameter] = dict(self.model.named_parameters())
        tx = build_optimizer(list(params.values()), **self.optim_config)
        return EmaTrainState.create(params, tx, use_ema=self.use_ema).replicate(self.mesh)

    @torch.no_grad()
    def _encode(self, x: torch.Tensor, generator: Optional[torch.Generator],
                sample: bool, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Pixel seq (B,T,H,W,C) -> scaled latent seq: the posterior's sample
        (from ``generator``; ``rows`` (first, total): those rows of the global
        batch's draw) or mode."""
        B = x.shape[0]
        moments = self.vae.encode_moments(x.reshape((-1,) + tuple(x.shape[2:])))
        return self._latents(moments.reshape((B, -1) + tuple(moments.shape[1:])), generator,
                             sample, rows)

    @torch.no_grad()
    def _latents(self, moments: torch.Tensor, generator: Optional[torch.Generator],
                 sample: bool, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Encoder moments (B,T,h,w,2c) -> scaled latent seq; the tail of
        :meth:`_encode`, shared with training from cached moments."""
        return latents_from_moments_seq(moments, generator=generator, sample_posterior=sample,
                                        scale_factor=self.scale_factor, rows=rows)

    def _draw(self, generator: Optional[torch.Generator], z: torch.Tensor,
              rows: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """t and the noise of one step, from ``generator``, after the posterior
        sample (``rows``: those rows of the global batch's draws)."""
        t = randint_rows(self.schedule.num_timesteps, z.shape[0], generator, self.device, rows)
        return t, randn_rows(z.shape, generator, self.device, z.dtype, rows)

    def p_losses(self, z: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                 target: torch.Tensor, dropout_seed: Optional[int] = None,
                 dropout_first_row: int = 0):
        """Noise ``z`` to step ``t``, regress U(z_t, t) onto ``target``:
        ``(loss, loss_dict)``.  ``dropout_seed`` seeds the masks in training
        mode, from z's first row in the global batch ``dropout_first_row``."""
        zt = core.q_sample(self.schedule, z, t, noise)
        kwargs = {} if dropout_seed is None else {"dropout_seed": int(dropout_seed),
                                                  "dropout_first_row": int(dropout_first_row)}
        pred = self.model(zt, t, **kwargs)
        loss = self._loss(pred, target)
        mae = (pred - target).abs().mean()
        avg_gt = target.abs().mean()
        return loss, {"mae": mae, "avg_gt": avg_gt, "relative_mae": mae / (avg_gt + 1e-8)}

    def loss_fn(self, generator: Optional[torch.Generator], x: torch.Tensor, y: torch.Tensor,
                target: Optional[torch.Tensor] = None, dropout_seed: Optional[int] = None):
        """x: target pixel seq (B,T_out,H,W,C); y: context seq (B,T_in,H,W,C).
        With ``latent_inputs``, x and y are cached moments windows and
        ``target`` the cached per-frame pixel mean (B,T_out,1).  The context
        is not encoded: the network ignores its latent ``zc`` (the posterior
        mode), as the reference's does (models.py:459), and XLA drops the JAX
        loss's encode of it, which draws nothing."""
        x = x.to(self.device, torch.float32)
        rows = batch_rows(x.shape[0], self.mesh)
        if self.latent_inputs:
            if target is None:
                raise ValueError("latent_inputs: the step needs the cached target")
            z = self._latents(x, generator, sample=True, rows=rows)
            target = target.to(self.device, torch.float32)
        else:
            z = self._encode(x, generator, sample=True, rows=rows)
            target = self.target_fn(x)
        if rows is None:   # one process: the call as it always was
            t, noise = self._draw(generator, z)
            return self.p_losses(z, t, noise, target, dropout_seed)
        t, noise = self._draw(generator, z, rows)
        return self.p_losses(z, t, noise, target, dropout_seed, dropout_first_row=rows[0])

    def grads(self, state: EmaTrainState, seed: Union[int, torch.Generator], x: torch.Tensor,
              y: torch.Tensor, target: Optional[torch.Tensor] = None, reduce: bool = True):
        """One micro-step's ``(grads, loss_dict)`` without the update, in the
        order of ``state.params``; on a mesh their means over the ranks
        (``reduce=False``: this rank's own)."""
        self.model.train()
        generator = step_generator(seed, state.step, self.device)
        loss, loss_dict = self.loss_fn(generator, x, y, target,
                                       dropout_seed=step_dropout_seed(seed, state.step))
        grads = param_grads(loss, list(state.params.values()))
        mesh = self.mesh if reduce else None
        loss_dict = reduce_loss_dict({**loss_dict, "train_loss": loss}, mesh)
        if mesh is not None:   # the whole batch's ratio, as the JAX step's
            loss_dict["relative_mae"] = loss_dict["mae"] / (loss_dict["avg_gt"] + 1e-8)
        return all_reduce_mean(grads, mesh), loss_dict

    def train_step(self, state: EmaTrainState, seed: Union[int, torch.Generator],
                   x: torch.Tensor, y: torch.Tensor, target: Optional[torch.Tensor] = None
                   ) -> Tuple[EmaTrainState, Dict[str, torch.Tensor]]:
        """One micro-step: loss, every parameter's gradient (on a mesh their
        mean over the ranks), ``state.apply_gradients``.  Returns the state and
        the ``loss_dict`` with ``train_loss`` (0-dim tensors on the device)."""
        grads, loss_dict = self.grads(state, seed, x, y, target)
        state.apply_gradients(grads)
        return state, loss_dict
