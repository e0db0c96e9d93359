"""Exponential moving average of the parameters:

    decay_eff = min(decay, (1 + n) / (10 + n))     (warmup ramp)
    shadow   -= (1 - decay_eff) * (shadow - params)

with ``n`` the step count before this update.  f32 shadow only.
"""
from typing import Sequence

import torch


def ema_decay(decay: float, num_updates: int) -> float:
    """Warmup-ramped effective decay; ``num_updates < 0`` disables the ramp."""
    if num_updates < 0:
        return decay
    n = float(num_updates)
    return min(decay, (1.0 + n) / (10.0 + n))


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], new_params: Sequence[torch.Tensor],
               decay: float, num_updates: int) -> None:
    """Move each shadow tensor toward its parameter, in place."""
    d = ema_decay(decay, num_updates)
    torch._foreach_lerp_(list(ema_params), [p.detach() for p in new_params], 1.0 - d)
