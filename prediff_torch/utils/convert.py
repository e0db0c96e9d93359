"""Weight bridge: a flax parameter tree (as numpy), with its ``batch_stats``
where the module has BatchNorms -> a port module's state_dict, and a flax
train-state tree (parameters, gradients or EMA shadow) -> the port's
train-state names.

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
    ActNorm loc, scale (1,1,1,C)     -> loc, scale (1,C,1,1)
    BatchNorm batch_stats mean, var  -> running_mean, running_var
    anything else (bias, tables, the attention pool's positional_embedding,
    the global vectors' init_global_vectors (N, C))
                                     copied verbatim.

The model variants add no rule: ``HW_embed`` and the hierarchical position
embeddings are embeddings, ``ffn_1_gate``, the global nets (``l2g_q_net``,
``global_qkv``, ``global_proj``, ``down_layer_global_proj_*`` ...) and the
scale-shift blocks' ``emb_layers_1`` (2 x C outputs) are Linears,
``global_vec_norm`` a LayerNorm, ``global_ffn_l_*`` FFNs.

:func:`torch_params_to_flax` is the inverse: a reference state_dict (the
published ``.pt`` files) -> the flax tree, names and layouts of the JAX
package's converter (``prediff_tpu/utils/convert.py``
``convert_torch_state_dict``), where the module that owns a ``weight``
decides its flax leaf (Linear and Conv: ``kernel``; the norms: ``scale``;
Embedding: ``embedding``).
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


_RUNNING = {"running_mean": "mean", "running_var": "var"}
_KEPT = (torch.float32, torch.bfloat16, torch.float16)


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    """A flax leaf as a tensor of its own dtype; bf16 comes as numpy's
    ``bfloat16`` extension type or, read back from an ``.npz``, as 2-byte
    voids."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:   # a JAX array's buffer: the tensor gets its own copy
        arr = arr.copy()
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_torch_layout(flax_leaf: str, arr: np.ndarray) -> np.ndarray:
    if flax_leaf in ("loc", "scale") and arr.ndim == 4:   # ActNorm, NHWC -> NCHW
        return arr.transpose(0, 3, 1, 2)
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


def flax_params_to_torch(model: torch.nn.Module, flax_params,
                         batch_stats=None) -> Dict[str, torch.Tensor]:
    """Return a state_dict for ``model`` filled from ``flax_params`` and, for
    its BatchNorms' running statistics, from the flax ``batch_stats`` (the
    inverse of the JAX package's ``convert_torch_batch_stats``; the
    ``num_batches_tracked`` counters, which flax has not, keep the model's).

    Strict both ways: every key of ``model.state_dict()`` takes exactly one
    flax leaf and every flax leaf is taken, else ``ValueError``.  A leaf in
    f32, bf16 or f16 keeps its dtype (the JAX package's ``cast_to_bf16``
    trees, and its ``.npz`` files of them); any other takes the model's."""
    flat = flatten_tree(flax_params)
    flat.update({("batch_stats",) + k: v for k, v in flatten_tree(batch_stats or {}).items()})
    used = set()
    out = {}
    for key, ref in model.state_dict().items():
        base = torch_key_to_flax_path(key)
        if base[-1] == "num_batches_tracked":
            out[key] = ref.clone()
            continue
        if base[-1] in _RUNNING:
            candidates = [("batch_stats",) + base[:-1] + (_RUNNING[base[-1]],)]
        elif base[-1] == "weight":
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
        leaf = _leaf_tensor(arr)
        # a floating leaf keeps its dtype (a bf16 tree gives a bf16 state_dict)
        out[key] = leaf if ref.is_floating_point() and leaf.dtype in _KEPT else leaf.to(ref.dtype)
    unused = sorted("/".join(p) for p in flat if p not in used)
    if unused:
        raise ValueError(f"flax leaves with no port parameter ({len(unused)}): {unused[:10]}")
    return out


def flax_train_tree_to_torch(model: torch.nn.Module, tree,
                             name: str = "unet") -> Dict[str, torch.Tensor]:
    """A flax tree over the trainable parameters, ``{name: ..., ["logvar":
    ...]}`` -> the port's train-state names, ``"<name>.<state_dict key>"``
    and ``"logvar"``, in the port's layouts: the diffusion trainer's
    ``{"unet", "logvar"}`` and the VAE-GAN generator's ``{"vae", "logvar"}``.
    The layout change is linear, so the same function carries the
    parameters, a gradient tree or the EMA shadow of a flax train state."""
    out = {f"{name}.{k}": v for k, v in flax_params_to_torch(model, tree[name]).items()}
    if "logvar" in tree:
        out["logvar"] = torch.from_numpy(np.array(tree["logvar"], dtype=np.float32))
    return out


def _from_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    """The flax layout of a port leaf (the inverse of :func:`_to_torch_layout`)."""
    if leaf in ("loc", "scale") and arr.ndim == 4:        # ActNorm, NCHW -> NHWC
        return arr.transpose(0, 2, 3, 1)
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:                      # Linear
        return arr.T
    if arr.ndim == 3:                      # Conv1d O,I,k -> k,I,O
        return arr.transpose(2, 1, 0)
    if arr.ndim == 4:                      # Conv2d O,I,kh,kw -> kh,kw,I,O
        return arr.transpose(2, 3, 1, 0)
    if arr.ndim == 5:                      # Conv3d O,I,kt,kh,kw -> kt,kh,kw,I,O
        return arr.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"unexpected kernel rank {arr.ndim}")


_NORMS = (torch.nn.LayerNorm, torch.nn.GroupNorm, torch.nn.modules.batchnorm._BatchNorm)


def _flax_leaf(model: torch.nn.Module, key: str) -> str:
    """The flax leaf name of ``model``'s state_dict entry ``key``."""
    owner, _, leaf = key.rpartition(".")
    if leaf != "weight":
        return leaf
    mod = model.get_submodule(owner)
    if isinstance(mod, (torch.nn.Linear, torch.nn.modules.conv._ConvNd)):
        return "kernel"
    if isinstance(mod, _NORMS):
        return "scale"
    if isinstance(mod, torch.nn.Embedding):
        return "embedding"
    raise ValueError(f"'{key}': no flax leaf for the weight of a {type(mod).__name__}")


def torch_params_to_flax(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                         skip_suffixes: Tuple[str, ...] = ()) -> Dict:
    """The flax parameter tree (nested dicts of f32 numpy arrays, the JAX
    package's names and layouts) of ``state_dict``, a state_dict of
    ``model``'s architecture: what ``convert_torch_state_dict`` of the JAX
    package makes of it.  The BatchNorms' running statistics and counters
    (flax ``batch_stats``, which that converter leaves out) and keys ending
    in ``skip_suffixes`` (buffers derived from the configuration) are left
    out.  Strict: every parameter of ``model`` must be in ``state_dict`` and
    every other key skipped, else ``ValueError``."""
    own = model.state_dict()
    tree: Dict = {}
    left = []
    for key, value in state_dict.items():
        base = torch_key_to_flax_path(key)
        if base[-1] in _RUNNING or base[-1] == "num_batches_tracked" or key.endswith(skip_suffixes):
            continue
        if key not in own:
            left.append(key)
            continue
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        if tuple(arr.shape) != tuple(own[key].shape):
            raise ValueError(f"shape mismatch for '{key}': {arr.shape} vs port "
                             f"{tuple(own[key].shape)}")
        leaf = _flax_leaf(model, key)
        node = tree
        for part in base[:-1]:
            node = node.setdefault(part, {})
        if leaf in node:
            raise ValueError(f"flax leaf {'/'.join(base[:-1] + (leaf,))} taken twice")
        node[leaf] = _from_torch_layout(leaf, arr).astype(np.float32)
    missing = [k for k in own if k not in state_dict
               and torch_key_to_flax_path(k)[-1] not in _RUNNING
               and not k.endswith(("num_batches_tracked",) + tuple(skip_suffixes))]
    if left or missing:
        raise ValueError(f"state_dict does not fit the model: {len(missing)} missing "
                         f"{missing[:10]}, {len(left)} left over {left[:10]}")
    return tree


def extract_ema_state_dict(pl_state_dict: Dict[str, object],
                           model_prefix: str = "torch_nn_module.",
                           ema_prefix: str = "model_ema.") -> Dict[str, object]:
    """The EMA weights of a Lightning PreDiff checkpoint, keyed as the live
    model's state_dict (``prediff_tpu/utils/convert.py``
    ``extract_ema_state_dict``).  The reference's ``LitEma`` keeps each
    shadow under its parameter's name with the dots taken out; each is
    mapped back by the dot-stripped names of the ``model_prefix`` keys (an
    ambiguous one raises ``ValueError``); ``decay`` and ``num_updates`` are
    left out."""
    dotless = {}
    for key in pl_state_dict:
        if key.startswith(model_prefix):
            name = key[len(model_prefix):]
            flat = name.replace(".", "")
            if flat in dotless:
                raise ValueError(f"ambiguous dot-stripped EMA name '{flat}'")
            dotless[flat] = name
    out = {}
    for key, value in pl_state_dict.items():
        name = key[len(ema_prefix):] if key.startswith(ema_prefix) else None
        if name is not None and name not in ("decay", "num_updates") and name in dotless:
            out[dotless[name]] = value
    return out


def strip_prefix(state_dict: Dict[str, object], prefix: str) -> Dict[str, object]:
    """The keys under ``prefix``, the prefix cut (the reference's programs
    re-save bare ``torch_nn_module.`` state_dicts)."""
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
