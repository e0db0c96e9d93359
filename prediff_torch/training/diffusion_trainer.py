"""PreDiff (latent diffusion) training: encode -> q_sample -> UNet -> weighted
loss -> clip -> AdamW (warmup + cosine) -> EMA, on one device.

Counterpart of ``prediff_tpu/training/diffusion_trainer.py``.  Trainable:
the UNet and, when ``learn_logvar``, the per-step ``logvar``; the VAE is
frozen.  A step runs eagerly; what it draws (the posterior sample, t, the
noise) comes from a generator seeded from the caller's seed and
``state.step``, and its dropout masks from a third stream derived from the
same two integers (:func:`step_dropout_seed`, the JAX loss's ``rng_drop``),
on the host, without a device sync.  ``state.step`` counts micro-steps, so
the micro-steps of one optimizer step draw different masks, and a run
restored from a checkpoint repeats the run it was saved from.  On the card
cuDNN runs its deterministic algorithms (set with the device,
:func:`~prediff_torch.utils.device.set_deterministic`): the hand-written
kernels sum in a fixed order, and with that switch the library's convolution
gradients do too, so the same step gives the same bits.

Several ranks (``mesh``, a ``parallel.DataMesh``; the JAX trainer's ``mesh``,
which places the state replicated and the batch sharded and lets XLA insert
the gradient all-reduce): every rank holds the whole state, created and then
set to the mesh's first rank's (``EmaTrainState.replicate``), and its own
rows of the global batch, the same count on each.  A micro-step draws the
global batch's numbers and takes its rows (``LatentDiffusion.training_loss``
with the mesh), takes its gradients with ``torch.autograd.grad``, and
all-reduces their mean over the ranks, written out as one flat bucket
(``parallel.all_reduce_mean``): ``DistributedDataParallel``'s reducer fires
only on ``.backward()`` into ``.grad``.  The reduction runs every micro-step,
as the JAX step's (the accumulation averages reduced gradients, and
``grad_norm`` is the global micro-gradient's); ``grad_norm``, the clip and the
update act on the reduced gradients, so the ranks' states stay bit-equal,
and the ``loss_dict`` holds the means over the ranks, the global batch's.

The JAX trainer's opt-ins: ``remat_unet`` recomputes the UNet's activations
in the backward of a training step (the UNet's ``remat``: one checkpoint
segment per block pair, the draws outside every segment; the gradients keep
their bits), never in validation; ``ema_dtype`` stores the EMA shadow
narrower (``EmaTrainState``) and ``optim_config["state_dtype"]`` the Adam
moments (``build_optimizer``).

K micro-steps per call (the JAX trainer's ``make_train_step_scan``, a
``lax.scan`` of the step body; ``fit(steps_per_call=K)``):
:meth:`DiffusionTrainer.train_step_scan` takes (K, B, ...) stacks of
micro-batches (on a mesh this rank's rows, the JAX chunk's ``P(None,
"data")``) and returns the state and the loss dicts stacked (K,), equal to
K calls of :meth:`~DiffusionTrainer.train_step`, with everything the single
step takes: a ``mesh``, ``remat_unet``, a ``state_dtype``, an ``ema_dtype``.
On the card the K micro-steps are replays of captured CUDA graphs
(``step_graphs.py``; on NCCL the all-reduce inside the graph, on gloo
between a micro-step's two graphs, through the host): bit for bit K eager
micro-steps, and a capture that fails raises.  On a CPU device the K
micro-steps run the captured micro-step's code eagerly.  Refused when asked
for, not carried over from the JAX trainer: the TPU / XLA layout and RNG
knobs ``prng_impl``, ``flat_update``, ``pack_small_thr``,
``matmul_precision``, ``conv3d_impl``.
"""
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..diffusion.latent_diffusion import LatentDiffusion
from ..parallel.mesh import DataMesh, all_reduce_mean, reduce_loss_dict
from ..utils.convert import torch_key_to_flax_path
from .optim import build_optimizer, global_norm
from .step_graphs import ScanGraphs
from .train_state import EmaTrainState, param_grads

_TPU_KNOBS = {"prng_impl": None, "flat_update": False, "pack_small_thr": 0,
              "matmul_precision": None, "conv3d_impl": None}


def refuse_knobs(owner: str, knobs: Dict, allowed: Dict) -> None:
    """Raise for an argument ``owner`` does not take, and for a TPU knob of
    ``allowed`` at anything but its default (``"auto"`` of ``prng_impl`` and
    ``conv3d_impl`` is the default off a TPU)."""
    for name, value in knobs.items():
        if name not in allowed:
            raise TypeError(f"{owner}: unexpected argument '{name}'")
        if value != allowed[name] and not (name in ("prng_impl", "conv3d_impl")
                                           and value == "auto"):
            raise NotImplementedError(f"{name}={value!r}: a TPU / XLA knob, not carried over "
                                      "(ROADMAP.md)")


def step_generator(seed: Union[int, torch.Generator], step: int, device) -> torch.Generator:
    """The generator of one step: seeded from the run's seed (or a
    generator's initial seed) and the step count, on ``device``."""
    if isinstance(seed, torch.Generator):
        seed = seed.initial_seed()
    words = np.random.SeedSequence([int(seed) % 2**63, int(step)]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed((int(words[0]) << 31) ^ int(words[1]))


def step_dropout_seed(seed: Union[int, torch.Generator], step: int) -> int:
    """The 64-bit dropout seed of one micro-step: derived like
    :func:`step_generator`'s from the run's seed and the step count
    (``state.step``, which counts micro-steps: the micro-steps of one
    optimizer step get different seeds), with a third word that keeps it
    apart from the generator's stream.  The UNet numbers its dropout sites
    under this seed in call order."""
    if isinstance(seed, torch.Generator):
        seed = seed.initial_seed()
    words = np.random.SeedSequence([int(seed) % 2**63, int(step), 1]).generate_state(2, np.uint32)
    return (int(words[0]) << 32) | int(words[1])


class DiffusionTrainer:
    """Train and validation steps of the latent diffusion model ``ld`` (from
    :func:`~prediff_torch.factory.build_training_pipeline`)."""

    def __init__(self, ld: LatentDiffusion, optim_config: Optional[Dict] = None,
                 use_ema: bool = True, ema_decay: float = 0.9999,
                 track_grad_norm: bool = False, latent_inputs: bool = False,
                 mesh: Optional[DataMesh] = None, remat_unet: bool = False,
                 ema_dtype: Optional[str] = None, **knobs):
        refuse_knobs("DiffusionTrainer", knobs, _TPU_KNOBS)
        if any(p.requires_grad for p in ld.vae.parameters()):
            raise ValueError("the VAE must be frozen")
        if mesh is not None and mesh.device.type != ld.device.type:
            raise ValueError(f"the mesh's device {mesh.device} is not the pipeline's {ld.device}")
        self.ld = ld
        self.mesh = mesh
        self.optim_config = dict(optim_config or {})
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        self.track_grad_norm = track_grad_norm
        self.remat_unet = bool(remat_unet)
        self.ema_dtype = ema_dtype
        # True: the steps take first-stage moments (mx, my) instead of pixel
        # windows (x, y), and the frozen VAE encode drops out of the step
        self.latent_inputs = latent_inputs
        self.scan_graphs: Optional[ScanGraphs] = None   # train_step_scan's, on the card

    def create_state(self) -> EmaTrainState:
        """A fresh state over the pipeline's UNet (put in training mode, where
        its dropout rates are active) and a new ``logvar`` when it is learned."""
        self.ld.unet.train().requires_grad_(True)
        params: Dict[str, nn.Parameter] = {f"unet.{k}": p
                                           for k, p in self.ld.unet.named_parameters()}
        if self.ld.learn_logvar:
            params["logvar"] = nn.Parameter(self.ld.init_logvar())
        tx = build_optimizer(list(params.values()), **self.optim_config)
        state = EmaTrainState.create(params, tx, use_ema=self.use_ema, ema_decay=self.ema_decay,
                                     ema_dtype=self.ema_dtype)
        return state.replicate(self.mesh)

    def _loss(self, logvar, generator, x, y, prefix: str, latent: Optional[bool] = None,
              unet_params=None, dropout_seed=None, draws=None):
        latent = self.latent_inputs if latent is None else latent
        fn = self.ld.training_loss_from_moments if latent else self.ld.training_loss
        return fn(logvar, generator, x, y, prefix=prefix, unet_params=unet_params,
                  dropout_seed=dropout_seed, mesh=self.mesh, draws=draws)

    def _logvar(self, state: EmaTrainState) -> torch.Tensor:
        return state.params["logvar"] if "logvar" in state.params else self.ld.init_logvar()

    def _local_grads(self, state: EmaTrainState, generator, x, y, dropout_seed, draws=None):
        """Loss dict and gradients of one micro-step on this rank's rows,
        its draws from ``generator`` (or ``draws``), its masks from
        ``dropout_seed``."""
        self.ld.unet.train()
        self.ld.unet.remat = self.remat_unet
        try:
            loss, loss_dict = self._loss(self._logvar(state), generator, x, y, "train",
                                         dropout_seed=dropout_seed, draws=draws)
        finally:
            self.ld.unet.remat = False
        # in the parameters' layouts (cuDNN hands a convolution's weight gradient
        # back channels-last): the norms then sum as they do on a mesh's bucket
        grads = [g.contiguous() for g in param_grads(loss, list(state.params.values()))]
        return grads, loss_dict

    def grads(self, state: EmaTrainState, seed: Union[int, torch.Generator], x: torch.Tensor,
              y: torch.Tensor, reduce: bool = True):
        """One micro-step's ``(grads, loss_dict)`` without the update: the
        gradient of every trainable parameter, in the order of
        ``state.params``, and the detached losses; on a mesh their means over
        the ranks (``reduce=False``: this rank's own)."""
        generator = step_generator(seed, state.step, self.ld.device)
        grads, loss_dict = self._local_grads(state, generator, x, y,
                                             step_dropout_seed(seed, state.step))
        mesh = self.mesh if reduce else None
        return all_reduce_mean(grads, mesh), reduce_loss_dict(loss_dict, mesh)

    def _norms(self, state: EmaTrainState, grads, loss_dict: Dict[str, torch.Tensor]) -> None:
        """``grad_norm`` (and with ``track_grad_norm`` the norm per top-level
        module) of the micro-gradients into ``loss_dict``."""
        loss_dict["grad_norm"] = global_norm(grads)
        if self.track_grad_norm:
            by_module: Dict[str, list] = {}
            for name, g in zip(state.params, grads):
                # per top-level module, under the flax tree's name for it
                key = ("logvar" if name == "logvar"
                       else "unet." + torch_key_to_flax_path(name[len("unet."):])[0])
                by_module.setdefault(key, []).append(g)
            for key, gs in by_module.items():
                loss_dict[f"grad_norm/{key}"] = global_norm(gs)

    def train_step(self, state: EmaTrainState, seed: Union[int, torch.Generator],
                   x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[EmaTrainState, Dict[str, torch.Tensor]]:
        """One micro-step on target ``x`` and context ``y`` (pixels, or
        moments with ``latent_inputs``; on a mesh this rank's rows): loss,
        gradients of every trainable parameter (on a mesh their mean over the
        ranks), ``state.apply_gradients``.  Returns the state and the
        ``loss_dict`` (0-dim tensors on the device; ``grad_norm`` is the
        global norm of this micro-step's gradients before the clip)."""
        grads, loss_dict = self.grads(state, seed, x, y)
        self._norms(state, grads, loss_dict)
        state.apply_gradients(grads)
        return state, loss_dict

    def _scan_apply(self, state: EmaTrainState, grads, loss_dict) -> Dict[str, torch.Tensor]:
        """The norms, then the update on the state's device scalars as loaded."""
        self._norms(state, grads, loss_dict)
        state.apply_loaded(grads)
        return loss_dict

    def _scan_grads(self, state: EmaTrainState, b):
        """This rank's gradients and loss dict of one micro-step on the static
        buffers ``b`` (``step_graphs.ScanBuffers``): what the graphs capture
        before the reduction over the mesh."""
        return self._local_grads(state, None, b.x, b.y, b.seed, draws=(b.eps, b.t, b.noise))

    def make_train_step_scan(self):
        """The K-micro-steps-per-call function, :meth:`train_step_scan` (its
        graphs are kept on the trainer)."""
        return self.train_step_scan

    def train_step_scan(self, state: EmaTrainState, seed: Union[int, torch.Generator],
                        xs: torch.Tensor, ys: torch.Tensor
                        ) -> Tuple[EmaTrainState, Dict[str, torch.Tensor]]:
        """K micro-steps on ``xs``, ``ys`` stacked (K, B, ...) on the leading
        axis (stacked on the host: they cross to the card in one copy), as K
        calls of :meth:`train_step` give them: returns the state and each
        loss dict entry stacked (K,).  On the card the micro-steps replay
        captured graphs (module docstring); on a CPU device the same
        micro-step on the same buffers runs eagerly.  On a mesh ``xs`` and
        ``ys`` are this rank's rows of each micro-batch, as
        :meth:`train_step` takes them."""
        K = int(xs.shape[0])
        if ys.shape[0] != K:
            raise ValueError(f"train_step_scan: {K} target micro-batches, {ys.shape[0]} contexts")
        device = self.ld.device
        xs, ys = xs.to(device, non_blocking=True), ys.to(device, non_blocking=True)
        if self.scan_graphs is None:
            self.scan_graphs = ScanGraphs(self.ld.training_draws, self.ld.training_draw_shapes,
                                          device, self.mesh)
        first = state.step
        seeds = [step_dropout_seed(seed, first + k) for k in range(K)]
        generators = [step_generator(seed, first + k, device) for k in range(K)]

        def key():
            return ScanGraphs.key(state, [self.ld.unet, self.ld.vae], xs[0], ys[0],
                                  (self.ld.scale_factor, self.latent_inputs,
                                   self.track_grad_norm, self.remat_unet), self.mesh)

        return state, self.scan_graphs.run(self._scan_grads, self._scan_apply, state, seeds,
                                           generators, xs, ys, key)

    @torch.no_grad()
    def val_step(self, state: EmaTrainState, seed: Union[int, torch.Generator], x: torch.Tensor,
                 y: torch.Tensor, use_ema: bool = True,
                 latent_inputs: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """The loss on a validation batch with the EMA weights (``use_ema``)
        in eval mode (no dropout); the ``loss_dict`` under ``val/``, on a mesh
        its means over the ranks.  ``latent_inputs=False`` forces pixel inputs
        for a trainer that trains from moments."""
        unet_params = None
        if use_ema and state.use_ema:
            unet_params = state.ema_param_tree("unet.")
        was_training = self.ld.unet.training
        self.ld.unet.eval()
        try:
            generator = step_generator(seed, 0, self.ld.device)
            _, loss_dict = self._loss(self._logvar(state), generator, x, y, "val",
                                      latent=latent_inputs, unet_params=unet_params)
        finally:
            self.ld.unet.train(was_training)
        return reduce_loss_dict(loss_dict, self.mesh)
