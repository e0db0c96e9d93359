"""Exponential moving average of the parameters:

    decay_eff = min(decay, (1 + n) / (10 + n))     (warmup ramp)
    shadow   -= (1 - decay_eff) * (shadow - params)

with ``n`` the step count before this update.  A shadow stored narrower
than its parameters (the train state's ``ema_dtype``) is widened, moved in
the parameters' dtype and rounded only where it is stored, as in the JAX
package's ``ema_update``.  The weight ``1 - decay_eff`` may come as a 0-dim
device tensor (the train state's, loaded before each micro-step), so a
captured micro-step moves the shadow by the ramp's value of its step, in
either dtype.
"""
from typing import Optional, Sequence

import torch

from .optim import chunks, widened


def ema_decay(decay: float, num_updates: int) -> float:
    """Warmup-ramped effective decay; ``num_updates < 0`` disables the ramp."""
    if num_updates < 0:
        return decay
    n = float(num_updates)
    return min(decay, (1.0 + n) / (10.0 + n))


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], new_params: Sequence[torch.Tensor],
               decay: float, num_updates: int, weight: Optional[torch.Tensor] = None) -> None:
    """Move each shadow tensor toward its parameter, in place:
    ``e -= w * (e - p)`` with ``w = 1 - decay_eff`` (the JAX package's form)
    in three foreach passes, ``w`` the 0-dim tensor ``weight`` where given
    (the train state's, loaded before each micro-step: a captured step moves
    the shadow by its own step's ramp), else filled from ``decay`` and
    ``num_updates``.  Where a shadow tensor is narrower than its parameter
    the passes run on the shadow widened to f32 (the parameters', which
    train in f32), a run of parameters at a time, and the result is rounded
    to the shadow's dtype."""
    ema_params, new_params = list(ema_params), [p.detach() for p in new_params]
    if weight is None:
        weight = torch.full((), 1.0 - ema_decay(decay, num_updates), dtype=torch.float32,
                            device=ema_params[0].device)

    def move(shadow, params):
        diff = torch._foreach_sub(shadow, params)
        torch._foreach_mul_(diff, weight)
        torch._foreach_sub_(shadow, diff)

    if all(e.dtype == p.dtype for e, p in zip(ema_params, new_params)):
        move(ema_params, new_params)
        return
    start = 0
    for params in chunks(new_params):
        shadow = ema_params[start:start + len(params)]
        start += len(params)
        wide, store = widened(shadow, params)        # exact
        move(wide, params)
        store()                                       # only the store rounds
