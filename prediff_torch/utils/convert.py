"""Weight bridge: a flax parameter tree (as numpy) -> a port module's state_dict,
and a flax train-state tree (parameters, gradients or EMA shadow) -> the
port's train-state names.

The port's module attribute paths follow the reference PyTorch names
(``down_self_blocks.0.1.attn_l.0.qkv.weight``, the diffusers VAE names), and
the flax tree merges each list index into its parent's name
(``down_self_blocks_0_1 / attn_l_0 / qkv / kernel``).  So the mapping is
mechanical: walk the port module's own ``state_dict()`` keys, map each to its
flax path, and invert the flax leaf layout:

    Linear  kernel (in,out)          -> weight (out,in)         [transpose]
    Conv1d  kernel (k,I,O)           -> weight (O,I,k)
    Conv2d  kernel (kh,kw,I,O)       -> weight (O,I,kh,kw)
    Conv3d  kernel (kt,kh,kw,I,O)    -> weight (O,I,kt,kh,kw)
    Norm    scale                    -> weight
    Embed   embedding                -> weight
    anything else (bias, tables, the attention pool's positional_embedding)
                                     copied verbatim.
"""
from typing import Dict, Tuple

import numpy as np
import torch


def torch_key_to_flax_path(key: str) -> Tuple[str, ...]:
    """'a.0.1.b.2.weight' -> ('a_0_1', 'b_2', 'weight')."""
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return tuple(merged)


def flatten_tree(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, prefix + (k,)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _to_torch_layout(flax_leaf: str, arr: np.ndarray) -> np.ndarray:
    if flax_leaf != "kernel":
        return arr
    if arr.ndim == 2:                      # Linear
        return arr.T
    if arr.ndim == 3:                      # Conv1d k,I,O -> O,I,k
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4:                      # Conv2d kh,kw,I,O -> O,I,kh,kw
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:                      # Conv3d kt,kh,kw,I,O -> O,I,kt,kh,kw
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


def flax_params_to_torch(model: torch.nn.Module, flax_params) -> Dict[str, torch.Tensor]:
    """Return a state_dict for ``model`` filled from ``flax_params``.

    Strict both ways: every key of ``model.state_dict()`` takes exactly one
    flax leaf and every flax leaf is taken, else ``ValueError``."""
    flat = flatten_tree(flax_params)
    used = set()
    out = {}
    for key, ref in model.state_dict().items():
        base = torch_key_to_flax_path(key)
        if base[-1] == "weight":
            candidates = [base[:-1] + (leaf,) for leaf in ("kernel", "scale", "embedding")]
        else:
            candidates = [base]
        found = [c for c in candidates if c in flat]
        if len(found) != 1:
            raise ValueError(f"'{key}' maps to {len(found)} flax leaves: {candidates}")
        path = found[0]
        if path in used:
            raise ValueError(f"flax leaf {'/'.join(path)} taken twice")
        used.add(path)
        arr = _to_torch_layout(path[-1], flat[path])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for '{key}': flax {arr.shape} vs port {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
    unused = sorted("/".join(p) for p in flat if p not in used)
    if unused:
        raise ValueError(f"flax leaves with no port parameter ({len(unused)}): {unused[:10]}")
    return out


def flax_train_tree_to_torch(unet: torch.nn.Module, tree) -> Dict[str, torch.Tensor]:
    """A flax tree over the trainable parameters, ``{"unet": ..., ["logvar":
    ...]}`` -> the port's train-state names, ``"unet.<state_dict key>"`` and
    ``"logvar"``, in the port's layouts.  The layout change is linear, so the
    same function carries the parameters, a gradient tree or the EMA shadow
    of a flax train state."""
    out = {f"unet.{k}": v for k, v in flax_params_to_torch(unet, tree["unet"]).items()}
    if "logvar" in tree:
        out["logvar"] = torch.from_numpy(np.array(tree["logvar"], dtype=np.float32))
    return out
