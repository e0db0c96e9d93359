"""Exponential moving average of the parameters:

    decay_eff = min(decay, (1 + n) / (10 + n))     (warmup ramp)
    shadow   -= (1 - decay_eff) * (shadow - params)

with ``n`` the step count before this update.  A shadow stored narrower
than its parameters (the train state's ``ema_dtype``) is widened, moved in
the parameters' dtype and rounded only where it is stored, as in the JAX
package's ``ema_update``.
"""
from typing import Sequence

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
               decay: float, num_updates: int) -> None:
    """Move each shadow tensor toward its parameter, in place: a lerp where
    every shadow tensor has its parameter's dtype, else ``e - (1 - d) (e - p)``
    on the shadow widened to f32 (the parameters', which train in f32), a run
    of parameters at a time, rounded to the shadow's dtype."""
    d = ema_decay(decay, num_updates)
    ema_params, new_params = list(ema_params), [p.detach() for p in new_params]
    if all(e.dtype == p.dtype for e, p in zip(ema_params, new_params)):
        torch._foreach_lerp_(ema_params, new_params, 1.0 - d)
        return
    start = 0
    for params in chunks(new_params):
        shadow = ema_params[start:start + len(params)]
        start += len(params)
        wide, store = widened(shadow, params)        # exact
        # e + w (p - e) = e - w (e - p), the JAX package's update, for w < 0.5
        torch._foreach_lerp_(wide, params, 1.0 - d)
        store()                                       # only the store rounds
