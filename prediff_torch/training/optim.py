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
"""
import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence

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


class Optimizer:
    """Clip, AdamW (or Adam) under the schedule, and accumulation, over a
    fixed list of parameters that it updates in place."""

    def __init__(self, params: Sequence[torch.Tensor], optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], gradient_clip_val: Optional[float],
                 accum_steps: int):
        self.params = list(params)
        self.optimizer = optimizer
        self.schedule = schedule
        self.gradient_clip_val = gradient_clip_val
        self.accum_steps = max(int(accum_steps), 1)
        self.count = 0          # updates made
        self.mini_step = 0      # micro-gradients in the running mean
        self.acc_grads: Optional[List[torch.Tensor]] = None

    @property
    def lr(self) -> float:
        """The rate the next update will use."""
        return self.schedule(self.count)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        """Take one micro-gradient; returns whether the parameters moved."""
        # in the parameters' own (contiguous) layout: cuDNN hands a convolution's
        # weight gradient back channels-last, which the fused optimizer refuses
        grads = [g.detach().contiguous() for g in grads]
        if self.accum_steps > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            # optax.MultiSteps: acc += (g - acc) / (mini_step + 1)
            w = 1.0 / (self.mini_step + 1)
            torch._foreach_lerp_(self.acc_grads, grads, w)
            self.mini_step += 1
            if self.mini_step < self.accum_steps:
                return False
            grads, self.mini_step = [a.clone() for a in self.acc_grads], 0
            torch._foreach_zero_(self.acc_grads)
        if self.gradient_clip_val:
            clip = float(self.gradient_clip_val)
            norm = global_norm(grads)
            grads = torch._foreach_mul(grads, clip / torch.clamp(norm, min=clip))
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        for p in self.params:
            p.grad = None
            # the fused AdamW step writes the parameters without bumping their
            # version counters; the kernels' bf16 weight copies (ops/weights.py)
            # are kept per version, so bump them here
            increment_version(p)
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count,
                "mini_step": self.mini_step,
                "acc_grads": None if self.acc_grads is None else list(self.acc_grads)}

    def load_state_dict(self, state: Dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
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
    """The recipe's optimizer over ``params``.  ``state_dtype`` (low-precision
    Adam moments) is not ported yet: anything but ``None`` raises."""
    if state_dtype is not None:
        raise NotImplementedError("state_dtype: low-precision Adam moments are not ported yet "
                                  "(ROADMAP.md queue 1, the trainer opt-ins)")
    schedule = build_lr_schedule(lr, total_num_steps, warmup_percentage, lr_scheduler_mode,
                                 min_lr_ratio, warmup_min_lr_ratio)
    params = list(params)
    # on the card, the optimizer's one-pass multi-tensor kernel in place of ~10 passes
    kw = dict(lr=schedule(0), betas=tuple(betas), eps=1e-8,
              fused=all(p.is_cuda for p in params))
    if method == "adamw":
        opt = torch.optim.AdamW(params, weight_decay=wd, **kw)
    elif method == "adam":
        opt = torch.optim.Adam(params, **kw)
    else:
        raise NotImplementedError(f"optimizer '{method}'")
    return Optimizer(params, opt, schedule, gradient_clip_val, accum_steps)
