"""Optimizer and learning-rate schedule of the training recipe: AdamW with a
linear warmup then cosine decay, global-norm gradient clipping and gradient
accumulation.

Counterpart of ``prediff_tpu/training/optim.py``, which chains optax
transformations; here :class:`Optimizer` wraps one ``torch.optim`` optimizer
and does, in optax's order, what the chain does:

* accumulation as ``optax.MultiSteps``: the running mean of k micro-gradients,
  one update every k calls, none in between;
* the clip as ``optax.clip_by_global_norm``: ``g * clip / max(norm, clip)``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead);
* the schedule evaluated at the count of updates made so far, from 0: the
  first update uses ``lr * warmup_min_lr_ratio``.

``state_dtype`` (the JAX package's ``_scale_by_adam_state_dtype``) stores both
Adam moments in a narrower dtype: :class:`AdamStateDtype` widens them to f32,
updates in f32 and rounds only what it stores.  The fused ``AdamW`` cannot
keep moments narrower than its parameters, so it runs on ``torch._foreach_*``
ops; the JAX package computes this update in XLA, not in a kernel.
"""
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch.autograd.graph import increment_version


def build_lr_schedule(lr: float, total_num_steps: int, warmup_percentage: float = 0.1,
                      lr_scheduler_mode: str = "cosine", min_lr_ratio: float = 1e-3,
                      warmup_min_lr_ratio: float = 0.1) -> Callable[[int], float]:
    """``count -> lr``: linear from ``lr * warmup_min_lr_ratio`` to ``lr``
    over ``max(1, int(total * warmup_percentage))`` updates, then cosine to
    ``lr * min_lr_ratio`` over the rest (or constant ``lr``)."""
    if lr_scheduler_mode not in ("cosine", "constant"):
        raise NotImplementedError(f"lr_scheduler_mode '{lr_scheduler_mode}'")
    warmup_steps = max(1, int(total_num_steps * warmup_percentage))
    rest = max(1, total_num_steps - warmup_steps)
    init = lr * warmup_min_lr_ratio

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return init + (lr - init) * (count / warmup_steps)
        if lr_scheduler_mode == "constant":
            return lr
        frac = min(count - warmup_steps, rest) / rest
        cosine = 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)

    return schedule


# the moment dtypes of ``state_dtype``
STATE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
CHUNK_ELEMENTS = 1 << 24    # parameters updated together: bounds the f32 temporaries


def state_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """``state_dtype`` / ``ema_dtype`` -> a torch dtype (None stays None);
    another name raises ``ValueError``."""
    if name is None:
        return None
    if not isinstance(name, str) or name not in STATE_DTYPES:
        raise ValueError(f"dtype {name!r}: takes None or one of {sorted(STATE_DTYPES)}")
    return STATE_DTYPES[name]


def get_loss_fn(loss: str = "l2") -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Name -> mean elementwise loss."""
    if loss in ("l2", "mse"):
        return lambda pred, target: (pred - target).square().mean()
    if loss in ("l1", "mae"):
        return lambda pred, target: (pred - target).abs().mean()
    raise NotImplementedError(f"loss '{loss}'")


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor (optax ``global_norm``),
    as the norm of the per-tensor norms: a few launches for hundreds of leaves."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def chunks(tensors: Sequence[torch.Tensor]):
    """``tensors`` in consecutive runs of at most ``CHUNK_ELEMENTS`` elements
    (a larger tensor alone): the runs a low-precision update widens at a time."""
    run, n = [], 0
    for t in tensors:
        if run and n + t.numel() > CHUNK_ELEMENTS:
            yield run
            run, n = [], 0
        run.append(t)
        n += t.numel()
    if run:
        yield run


def scratch(like: Sequence[torch.Tensor], dtype: torch.dtype):
    """``(flat, views)``: one uninitialised allocation of ``dtype`` and its
    views shaped as ``like``."""
    flat = torch.empty(sum(t.numel() for t in like), dtype=dtype, device=like[0].device)
    return flat, [v.view(t.shape) for v, t in zip(flat.split([t.numel() for t in like]), like)]


def widened(narrow: List[torch.Tensor], like: Sequence[torch.Tensor]):
    """f32 copies of the tensors ``narrow`` (shaped as ``like``), as views of
    one flat buffer, and ``store()``, which rounds them back into ``narrow``.
    The dtype changes in one launch each way over the flat buffers: a
    foreach copy across dtypes goes tensor by tensor."""
    nflat, nviews = scratch(like, narrow[0].dtype)
    wflat, wviews = scratch(like, torch.float32)
    torch._foreach_copy_(nviews, narrow)
    wflat.copy_(nflat)

    def store():
        nflat.copy_(wflat)
        torch._foreach_copy_(narrow, nviews)

    return wviews, store


class AdamStateDtype(torch.optim.Optimizer):
    """Adam, or AdamW with ``weight_decay``, in optax's form with both moments
    stored in ``state_dtype`` (the JAX package's ``_scale_by_adam_state_dtype``
    chained with ``add_decayed_weights`` and ``scale_by_learning_rate``):

        mu  = b1 m + (1 - b1) g                  nu = b2 v + (1 - b2) g^2     (f32)
        p  -= lr ((mu / bc1) / (sqrt(nu / bc2) + eps) + wd p)
        m, v = mu, nu rounded to ``state_dtype``

    with ``bc = 1 - b^count``.  Each run of parameters (:func:`chunks`) has
    its moments widened into one f32 buffer (:func:`widened`) and takes a few
    in-place foreach passes, as torch's own multi-tensor Adam orders them
    (``p (1 - lr wd)``, then ``p + (-lr / bc1) mu / (sqrt(nu) / sqrt(bc2) + eps)``).

    What changes from one update to the next, ``1 - lr wd``, ``-lr / bc1``
    and ``sqrt(bc2)``, is read from 0-dim f32 tensors on the parameters'
    device (``scalars``, one dict a group), which :meth:`load_scalars` fills
    from the rate and the update count it is given (the bias corrections in
    f32, as the JAX package computes them) without a sync; :meth:`step` is
    the device work on them, so a captured update replays with the values
    loaded before each replay.  It keeps no count of its own:
    :class:`Optimizer` loads its ``count`` and writes it into each group's
    ``"step"`` only for a checkpoint.  The moments are ``state["exp_avg"]`` /
    ``state["exp_avg_sq"]``.  Parameters must be f32 (a trainable model's)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, state_dtype: torch.dtype = torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, step=0))
        self.state_dtype = state_dtype
        self.scalars = []
        for group in self.param_groups:
            if any(p.dtype != torch.float32 for p in group["params"]):
                raise ValueError("state_dtype: the parameters must be float32")
            device = group["params"][0].device if group["params"] else None
            self.scalars.append({k: torch.zeros((), dtype=torch.float32, device=device)
                                 for k in ("decay", "step_size", "sqrt_bc2")})

    def _moments(self, p: torch.Tensor):
        st = self.state[p]
        if not st:
            st["exp_avg"] = torch.zeros_like(p, dtype=self.state_dtype)
            st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.state_dtype)
        return st["exp_avg"], st["exp_avg_sq"]

    def scalar_tensors(self) -> List[torch.Tensor]:
        return [t for sc in self.scalars for t in sc.values()]

    @torch.no_grad()
    def load_scalars(self, lr: float, count: int) -> None:
        """The numbers of update ``count`` (from 1) at rate ``lr`` into
        ``scalars`` (``fill_``: a launch with the value as its argument, no
        sync)."""
        for group, sc in zip(self.param_groups, self.scalars):
            group["lr"] = lr
            b1, b2 = group["betas"]
            wd = group["weight_decay"]
            # the bias corrections in f32, as the JAX package computes them
            n = np.float32(count)
            bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** n) for b in (b1, b2))
            sc["decay"].fill_(1.0 - lr * wd)
            sc["step_size"].fill_(-lr / bc1)
            sc["sqrt_bc2"].fill_(math.sqrt(bc2))

    @torch.no_grad()
    def step(self, closure=None):
        """The update on the loaded ``scalars``: device work only."""
        for group, sc in zip(self.param_groups, self.scalars):
            b1, b2 = group["betas"]
            for chunk in chunks([p for p in group["params"] if p.grad is not None]):
                grads = [p.grad for p in chunk]
                m, v = zip(*(self._moments(p) for p in chunk))
                wide, store = widened(list(m + v), chunk + chunk)   # exact
                mu, nu = wide[:len(chunk)], wide[len(chunk):]
                torch._foreach_lerp_(mu, grads, 1.0 - b1)
                torch._foreach_mul_(nu, b2)
                torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
                store()                              # only the stores round
                torch._foreach_sqrt_(nu)             # nu -> the denominator, from unrounded nu
                torch._foreach_div_(nu, sc["sqrt_bc2"])
                torch._foreach_add_(nu, group["eps"])
                if group["weight_decay"]:
                    torch._foreach_mul_(chunk, sc["decay"])
                torch._foreach_mul_(mu, sc["step_size"])   # mu -> the step, -lr mu / bc1
                torch._foreach_addcdiv_(chunk, mu, nu)

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        # the base class casts the moments to the parameters' dtype: back to the
        # stored one (exact: they were saved in it)
        for st in self.state.values():
            for key in ("exp_avg", "exp_avg_sq"):
                st[key] = st[key].to(self.state_dtype)


class Optimizer:
    """Clip, AdamW (or Adam) under the schedule, and accumulation, over a
    fixed list of parameters that it updates in place.  ``state_dtype`` is
    the moments' dtype name when they are stored narrower (``None``: the
    parameters' own).

    What changes from one micro-step to the next reaches the device as
    tensors, not as numbers baked into the launches: the learning rate (the
    torch optimizer's ``lr``, a 0-dim tensor, where it is fused or
    capturable: the fused ``AdamW`` reads it and its bias corrections' step
    count on the card; :class:`AdamStateDtype` reads its own ``scalars``,
    loaded from the rate and ``count``; the CPU's plain AdamW takes a
    host number at each update) and the divisor of the accumulation's
    running mean.  :meth:`load_scalars` writes them from the host's counters
    (``count``, ``mini_step``) without a sync, and :meth:`apply` runs the
    device work on them, so a captured micro-step (``training/step_graphs.py``)
    replays with the values loaded before each replay.  The host alone
    decides which micro-step updates (:meth:`updates_next`), from
    ``mini_step``."""

    def __init__(self, params: Sequence[torch.Tensor], optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], gradient_clip_val: Optional[float],
                 accum_steps: int, state_dtype: Optional[str] = None):
        self.params = list(params)
        self.state_dtype = state_dtype
        self.optimizer = optimizer
        self.schedule = schedule
        self.gradient_clip_val = gradient_clip_val
        self.accum_steps = max(int(accum_steps), 1)
        self.count = 0          # updates made
        self.mini_step = 0      # micro-gradients in the running mean
        self.acc_grads: Optional[List[torch.Tensor]] = None
        device = self.params[0].device if self.params else None
        # the rate of the next update and the running mean's divisor, mini_step + 1
        self.lr_t = torch.tensor(float(schedule(0)), dtype=torch.float32, device=device)
        self.div_t = torch.ones((), dtype=torch.float32, device=device)
        self._use_lr_tensor()

    def _use_lr_tensor(self) -> None:
        """A fused or capturable torch optimizer (``build_optimizer``'s on the
        card) reads ``lr_t``; :class:`AdamStateDtype` its own loaded scalars;
        another one takes the rate as a host number at each update
        (:meth:`apply`)."""
        self.own_scalars = isinstance(self.optimizer, AdamStateDtype)
        self.lr_on_device = self.own_scalars or all(g.get("fused") or g.get("capturable")
                                                    for g in self.optimizer.param_groups)
        if self.lr_on_device and not self.own_scalars:
            for group in self.optimizer.param_groups:
                group["lr"] = self.lr_t

    @property
    def lr(self) -> float:
        """The rate the next update will use."""
        return self.schedule(self.count)

    def updates_next(self) -> bool:
        """Whether the next micro-gradient moves the parameters."""
        return self.mini_step + 1 >= self.accum_steps

    def scalar_tensors(self) -> List[torch.Tensor]:
        """The device tensors :meth:`load_scalars` fills."""
        own = self.optimizer.scalar_tensors() if self.own_scalars else []
        return [self.lr_t, self.div_t] + own

    def load_scalars(self) -> None:
        """The next micro-step's rate and divisor into their device tensors
        (``fill_``: a launch with the value as its argument, no sync), and
        :class:`AdamStateDtype`'s numbers of update ``count + 1``."""
        lr = self.schedule(self.count)
        self.lr_t.fill_(lr)
        if self.own_scalars:
            self.optimizer.load_scalars(lr, self.count + 1)
        if self.accum_steps > 1:
            self.div_t.fill_(float(self.mini_step + 1))

    def advance(self) -> bool:
        """The host's counters past one micro-step, as :meth:`apply` moves
        them; returns whether it updated.  With an update, the parameters'
        version counters move (the device work may have run as a replay,
        which no counter sees)."""
        updated = self.updates_next()
        if updated:
            self.mini_step = 0
            self.count += 1
            for p in self.params:
                # the fused AdamW step (and the foreach ops) write the parameters without
                # bumping their version counters; the kernels' bf16 weight copies
                # (ops/weights.py) are kept per version, so bump them here
                increment_version(p)
        else:
            self.mini_step += 1
        return updated

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-gradient; returns whether the parameters moved."""
        self.load_scalars()
        return self.apply(grads)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor]) -> bool:
        """:meth:`update` on the device scalars as loaded: the device work of
        one micro-step, then :meth:`advance`."""
        # in the parameters' own (contiguous) layout: cuDNN hands a convolution's
        # weight gradient back channels-last, which the fused optimizer refuses
        grads = [g.detach().contiguous() for g in grads]
        if self.accum_steps > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            # optax.MultiSteps: acc += (g - acc) / (mini_step + 1)
            step = torch._foreach_sub(grads, self.acc_grads)
            torch._foreach_div_(step, self.div_t)
            torch._foreach_add_(self.acc_grads, step)
            del step
            if not self.updates_next():
                return self.advance()
            grads = self.acc_grads
        if self.gradient_clip_val:
            clip = float(self.gradient_clip_val)
            norm = global_norm(grads)
            grads = torch._foreach_mul(grads, clip / torch.clamp(norm, min=clip))
        if not self.lr_on_device:
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.count)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
        if self.accum_steps > 1:
            torch._foreach_zero_(self.acc_grads)
        return self.advance()

    def state_dict(self) -> Dict:
        if self.own_scalars:    # its groups' update count, as a torch optimizer saves it
            for group in self.optimizer.param_groups:
                group["step"] = self.count
        return {"optimizer": self.optimizer.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "state_dtype": self.state_dtype,
                "acc_grads": None if self.acc_grads is None else list(self.acc_grads)}

    def load_state_dict(self, state: Dict) -> None:
        """Restore in place; moments of another dtype than this optimizer
        stores raise ``ValueError`` (as in the JAX package, an f32 state and a
        low-precision one are not interchangeable)."""
        want = state_dtype_of(self.state_dtype)
        for i, st in state["optimizer"]["state"].items():
            dtype = want or self.params[int(i)].dtype
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st and st[key].dtype != dtype:
                    raise ValueError(f"checkpoint holds Adam moments in {st[key].dtype}, this "
                                     f"optimizer stores them in {dtype}")
        if state.get("state_dtype") != self.state_dtype:
            raise ValueError(f"checkpoint of state_dtype {state.get('state_dtype')!r}, this "
                             f"optimizer's is {self.state_dtype!r}")
        self.optimizer.load_state_dict(state["optimizer"])
        self._use_lr_tensor()   # the loaded groups hold the saved rate: the live tensor again
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        acc = state["acc_grads"]
        self.acc_grads = None if acc is None else [
            a.to(p.device, p.dtype).clone() for a, p in zip(acc, self.params)]


def build_optimizer(params: Sequence[torch.Tensor], lr: float = 1e-3,
                    total_num_steps: int = 100_000, method: str = "adamw", wd: float = 1e-5,
                    betas=(0.9, 0.999), gradient_clip_val: Optional[float] = 1.0,
                    warmup_percentage: float = 0.1, lr_scheduler_mode: str = "cosine",
                    min_lr_ratio: float = 1e-3, warmup_min_lr_ratio: float = 0.1,
                    accum_steps: int = 1, state_dtype: Optional[str] = None) -> Optimizer:
    """The recipe's optimizer over ``params``.  ``state_dtype`` (None, or
    "bfloat16", "float16", "float32"; another value raises ``ValueError``):
    both moments stored in that dtype (:class:`AdamStateDtype`)."""
    sdtype = state_dtype_of(state_dtype)
    schedule = build_lr_schedule(lr, total_num_steps, warmup_percentage, lr_scheduler_mode,
                                 min_lr_ratio, warmup_min_lr_ratio)
    params = list(params)
    if method not in ("adamw", "adam"):
        raise NotImplementedError(f"optimizer '{method}'")
    if sdtype is not None:
        opt = AdamStateDtype(params, lr=schedule(0), betas=betas, eps=1e-8,
                             weight_decay=wd if method == "adamw" else 0.0, state_dtype=sdtype)
        return Optimizer(params, opt, schedule, gradient_clip_val, accum_steps, state_dtype)
    # on the card, the optimizer's one-pass multi-tensor kernel in place of ~10 passes;
    # capturable: its step may be captured into a graph (its step count lives on the card)
    on_card = bool(params) and all(p.is_cuda for p in params)
    kw = dict(lr=schedule(0), betas=tuple(betas), eps=1e-8, fused=on_card, capturable=on_card)
    if method == "adamw":
        opt = torch.optim.AdamW(params, weight_decay=wd, **kw)
    else:
        opt = torch.optim.Adam(params, **kw)
    return Optimizer(params, opt, schedule, gradient_clip_val, accum_steps)
