"""Checkpoint save / restore of a train state, and a flat ``.npz`` export of
parameters.

A checkpoint is ``<path>/step_<n>.pt``: ``torch.save`` of the state's
``state_dict()`` (tensors, numbers, lists and dicts only), read back with
``torch.load(weights_only=True)`` so that loading runs no code from the file.
"""
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{int(step)}.pt")


def all_steps(path: str) -> List[int]:
    """Saved steps under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m)


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    keep: Optional[int] = 3) -> str:
    """Save ``state.state_dict()`` as step ``step`` (default: ``state.step``);
    with ``keep`` only the newest ``keep`` steps stay (``None`` keeps all, for
    a caller that retains checkpoints by score)."""
    os.makedirs(os.path.abspath(path), exist_ok=True)
    step = int(step if step is not None else state.step)
    target = _file(path, step)
    tmp = target + ".tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, target)
    if keep is not None:
        for old in all_steps(path)[:-keep]:
            delete_checkpoint(path, old)
    return target


def delete_checkpoint(path: str, step: int) -> None:
    """Remove one saved step (no-op when absent)."""
    target = _file(path, step)
    if os.path.exists(target):
        os.remove(target)


def restore_checkpoint(path: str, target: Any, step: Optional[int] = None) -> Any:
    """Load step ``step`` (default: the latest) into ``target`` in place, on
    the devices its tensors already lie on; returns ``target``."""
    steps = all_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoint under {path}")
    step = int(step if step is not None else steps[-1])
    state = torch.load(_file(path, step), map_location="cpu", weights_only=True)
    target.load_state_dict(state)
    return target


def save_params_npz(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Flat ``.npz`` export of name -> tensor."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def load_params_npz(path: str) -> Dict[str, torch.Tensor]:
    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]) for k in data.files}
