"""Compute dtypes by name, and low-precision copies of a module's weights.

The JAX package names its compute dtypes as strings (``compute_dtype`` of
the chain, of guidance and of the VAE trainer; ``first_stage_dtype``) and
resolves ``"auto"`` to bfloat16 on a TPU only: off a TPU, as here, it is
float32."""
import copy
from typing import Optional, Union

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
    ``dtype``, made once and brought up to date in place (``copy_``) when
    a parameter or buffer of ``module`` has moved since: one copy per
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
