"""Checkpoint save / restore of a train state, a flat ``.npz`` export of
parameters, and the readers of weights written elsewhere: the JAX package's
``.npz`` parameter trees and the reference's ``.pt`` files.

A checkpoint is ``<path>/step_<n>.pt``: ``torch.save`` of the state's
``state_dict()`` (tensors, numbers, lists and dicts only), read back with
``torch.load(weights_only=True)`` so that loading runs no code from the file.
On several ranks (``mesh``) the mesh's first rank alone writes and deletes,
and every rank waits for it at a barrier; a restore reads the same file on
every rank, which leaves the replicated states bit-equal.
"""
import os
import pickle
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..parallel.mesh import DataMesh, barrier

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{int(step)}.pt")


def all_steps(path: str) -> List[int]:
    """Saved steps under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(path)) if m)


def writes(mesh: Optional[DataMesh]) -> bool:
    """Whether this process writes the run's files: without a mesh, or as
    the mesh's first rank."""
    return mesh is None or not mesh.distributed or mesh.index == 0


def _wait(mesh: Optional[DataMesh]) -> None:
    if mesh is not None and mesh.distributed:
        barrier(mesh)


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    keep: Optional[int] = 3, mesh: Optional[DataMesh] = None) -> str:
    """Save ``state.state_dict()`` as step ``step`` (default: ``state.step``);
    with ``keep`` only the newest ``keep`` steps stay (``None`` keeps all, for
    a caller that retains checkpoints by score).  With a mesh only its first
    rank writes, and every rank returns after it has."""
    step = int(step if step is not None else state.step)
    target = _file(path, step)
    if writes(mesh):
        os.makedirs(os.path.abspath(path), exist_ok=True)
        tmp = target + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, target)
        if keep is not None:
            for old in all_steps(path)[:-keep]:
                delete_checkpoint(path, old)
    _wait(mesh)
    return target


def delete_checkpoint(path: str, step: int, mesh: Optional[DataMesh] = None) -> None:
    """Remove one saved step (no-op when absent; with a mesh its first rank
    alone, and every rank returns after it has)."""
    target = _file(path, step)
    if writes(mesh) and os.path.exists(target):
        os.remove(target)
    _wait(mesh)


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


def save_flax_npz(path: str, tree: Dict) -> None:
    """A nested flax tree of arrays as the JAX package's ``.npz`` export
    (``prediff_tpu/utils/checkpoint.py`` ``save_params_npz``): each leaf
    under its ``/``-joined path, so that both packages' ``from_npz`` read it."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            flat["/".join(prefix)] = np.asarray(node)

    walk(tree, ())
    np.savez(path, **flat)


def load_flax_npz(path: str) -> Dict:
    """The JAX package's ``.npz`` export (``prediff_tpu/utils/checkpoint.py``
    ``save_params_npz``: leaves under ``/``-joined paths) as its nested flax
    tree of numpy arrays, for ``utils.convert.flax_params_to_torch``."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree


# the reference's published weight files, by model (its utils/download.py)
PRETRAINED_NAMES = {
    "vae": "pretrained_sevirlr_vae_8x8x64_v1.pt",
    "earthformerunet": "pretrained_sevirlr_earthformerunet_v1.pt",
    "alignment": "pretrained_sevirlr_alignment_avg_x_cuboid_v1.pt",
    "i3d400": "pretrained_i3d_400.pt",
    "i3d600": "pretrained_i3d_600.pt",
}

# buffers of the reference's modules with no parameter of the port's (the
# suffixes the JAX package's converter skips): left out where the model does
# not keep them
DERIVED_BUFFERS = (
    "relative_position_index", "cond_ids", "betas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "lvlb_weights", "num_updates", "decay", "num_batches_tracked", "running_mean",
    "running_var")


def load_torch_state_dict(path: str, model: torch.nn.Module, prefix: str = "",
                          strict: bool = True) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` file, plain or Lightning-wrapped (``{"state_dict":
    ...}``), as a state_dict for ``model``: with ``prefix`` (e.g.
    ``"torch_nn_module."`` of a Lightning training checkpoint) only the keys
    under it, the prefix cut; the reference's derived buffers that ``model``
    does not keep left out.  ``strict`` (the JAX package's
    ``convert_torch_state_dict``): True leaves every other key in, so that
    ``model.load_state_dict`` raises for a key the model lacks or misses;
    False keeps only the keys ``model`` has, for
    ``load_state_dict(strict=False)``.  Read with
    ``torch.load(weights_only=True)`` unless the file holds more than tensors
    and containers, which only a full unpickling (code from the file) reads."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if prefix:
        ckpt = {k[len(prefix):]: v for k, v in ckpt.items() if k.startswith(prefix)}
    own = model.state_dict()
    out = {k: v for k, v in ckpt.items() if k in own or not k.endswith(DERIVED_BUFFERS)}
    return out if strict else {k: v for k, v in out.items() if k in own}
