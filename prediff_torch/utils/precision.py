"""Compute dtypes by name, parameter casts, and copies of a module's weights
in another dtype.

The JAX package names its compute dtypes as strings (``compute_dtype`` of
the chain, of guidance and of the VAE trainer; ``first_stage_dtype``) and
resolves ``"auto"`` to bfloat16 on a TPU only: off a TPU, as here, it is
float32.

:func:`cast_to_bf16` / :func:`cast_to_fp32` are the JAX package's
``prediff_tpu/utils/precision.py`` casts on the port's parameter trees: a
forecast on bf16 parameters is ``PreDiffPredictor(params=cast_to_bf16(params),
compute_dtype="bfloat16")``.  A model then runs as flax promotes
(:class:`Promoted`): on an input of dtype d, in ``promote(d, its parameters'
dtype)``, on a copy of its parameters in that dtype where that is wider.
"""
import copy
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def resolve_dtype(value: Union[str, torch.dtype], what: str) -> torch.dtype:
    """The floating dtype ``value`` names (its name or the torch dtype);
    ``"auto"`` is float32, the JAX package's resolution off a TPU.  Any
    other value raises ``ValueError``."""
    if value == "auto":
        return torch.float32
    if isinstance(value, torch.dtype) and value in FLOAT_DTYPES.values():
        return value
    if isinstance(value, str) and value in FLOAT_DTYPES:
        return FLOAT_DTYPES[value]
    raise ValueError(f"{what} {value!r}: takes one of {sorted(FLOAT_DTYPES)} or 'auto'")


def dtype_name(dtype: torch.dtype) -> str:
    return next(k for k, v in FLOAT_DTYPES.items() if v == dtype)


def versions(module: nn.Module) -> tuple:
    """``(data_ptr, _version)`` of every parameter and buffer of ``module``."""
    return tuple((t.data_ptr(), t._version) for t in (*module.parameters(), *module.buffers()))


class LowCopy:
    """A copy of ``module`` with its floating parameters and buffers in
    ``dtype`` (narrower or wider than its own), made once and brought up to
    date in place (``copy_``) when a parameter or buffer of ``module`` has
    moved since: one copy per
    version, and its tensors keep their addresses, so the bf16 weight
    layouts of ``ops/weights.py`` and a captured graph see a version move
    and nothing else.  An update through ``.data`` bypasses the version
    counter and is not seen."""

    def __init__(self, module: nn.Module, dtype: torch.dtype):
        self.module = module
        self.dtype = dtype
        self.copy: Optional[nn.Module] = None
        self._seen: Optional[tuple] = None

    def get(self) -> nn.Module:
        now = versions(self.module)
        if self.copy is None:
            self.copy = copy.deepcopy(self.module).to(self.dtype).requires_grad_(False)
        elif now != self._seen:
            with torch.no_grad():
                for low, src in zip((*self.copy.parameters(), *self.copy.buffers()),
                                    (*self.module.parameters(), *self.module.buffers())):
                    low.copy_(src)
        self.copy.train(self.module.training)
        self._seen = now
        return self.copy


def cast_pytree(tree: Any, dtype: Union[str, torch.dtype]) -> Any:
    """Every floating tensor of ``tree`` cast to ``dtype`` (integer and bool
    tensors, such as ``relative_position_index``, untouched).  A tree is a
    tensor, a dict of trees (a state_dict, or the dict of them under "unet",
    "vae", "align"), or an ``nn.Module``, which gives a cast copy and leaves
    the original as it is, as JAX returns a new tree."""
    dtype = resolve_dtype(dtype, "cast dtype")
    if isinstance(tree, nn.Module):
        return copy.deepcopy(tree).to(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_pytree(v, dtype)) for k, v in tree.items())
    return tree


def cast_to_bf16(tree: Any) -> Any:
    return cast_pytree(tree, torch.bfloat16)


def cast_to_fp32(tree: Any) -> Any:
    return cast_pytree(tree, torch.float32)


def floating_dtype(tensors, what: str) -> Optional[torch.dtype]:
    """The one dtype of the floating tensors among ``tensors`` (None where
    none is floating); more than one raises ``ValueError``: a model takes
    one parameter dtype."""
    dtypes = sorted({t.dtype for t in tensors if t.is_floating_point()}, key=str)
    if len(dtypes) > 1:
        raise ValueError(f"{what}: floating parameters in {len(dtypes)} dtypes {dtypes}; "
                         "a model takes one (cast the whole tree: cast_to_bf16 / cast_to_fp32)")
    return dtypes[0] if dtypes else None


def param_dtype(module: nn.Module) -> torch.dtype:
    """The dtype of ``module``'s parameters (the factories keep one a model);
    float32 for a module without any."""
    return next((p.dtype for p in module.parameters() if p.is_floating_point()), torch.float32)


class Promoted:
    """``module`` under flax's promotion rule: on an input of dtype d it runs
    in ``promote(d, its parameters' dtype)`` (:meth:`for_input`); where that is
    wider than its parameters, on a copy of them in that dtype (a
    :class:`LowCopy` per dtype: made once, brought up to date once per
    parameter version).  A bf16 module on an f32 input runs in f32 on its
    bf16-rounded weights, as the JAX package's bf16 tree does there."""

    def __init__(self, module: nn.Module):
        self.module = module
        self._copies: Dict[torch.dtype, LowCopy] = {}

    def low(self, dtype: torch.dtype) -> LowCopy:
        """The copy kept for ``dtype`` (its ``.copy`` None until first used)."""
        return self._copies.setdefault(dtype, LowCopy(self.module, dtype))

    def get(self, dtype: torch.dtype) -> nn.Module:
        """The module in ``dtype``: itself where its parameters are in it,
        else its copy, up to date."""
        if param_dtype(self.module) == dtype:
            return self.module
        return self.low(dtype).get()

    def for_input(self, input_dtype: torch.dtype) -> nn.Module:
        return self.get(torch.promote_types(input_dtype, param_dtype(self.module)))

    def copies(self) -> List[nn.Module]:
        """The copies made so far, for a graph's snapshot of what it reads."""
        return [c.copy for c in self._copies.values() if c.copy is not None]
