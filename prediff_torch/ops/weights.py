"""bf16 copies of the weights that the Hopper kernels read by TMA, laid out
once per parameter version, with their TMA tensor maps.

A layout is kept under the parameter's ``(data_ptr(), _version, device)``,
so an in-place update (``optimizer.step()``, ``torch._foreach_lerp_``,
``copy_`` under ``no_grad``) makes a new one at the next call.  The cache is
a module dict that holds each parameter by weak reference and drops its
entry when the parameter goes: nothing is stored on the parameter, so
nothing of it travels into ``torch.save``.  Each distinct tensor has its own
entry: the EMA tensors handed to ``torch.func.functional_call`` are laid out
apart from the parameters they shadow.  An update through ``weight.data``
bypasses PyTorch's version counter and is not seen.

Under :func:`recasting` (a captured training step, ``training/step_graphs.py``)
every call launches the cast into the layout already in place, whatever the
version: a graph replays that launch, so the copy follows the parameters that
the replayed optimizer step moved, at the address its tensor maps hold.

Kinds: ``"linear"``, the bf16 copy of a ``Linear`` weight (N, K), whose
PyTorch layout already is the K-major operand a wgmma wants, with a tensor
map per box height (``csrc/hopper.cuh`` ``bf16_matrix_map``: boxes of 64
columns); ``"linear_t"``, the bf16 copy of its transpose (K, N), the K-major
operand of a product that contracts over the weight's rows (the backwards'
``do . W`` and ``dh . W1``), laid out once per version like the other; the
conv's layouts (``ops/conv3d.weight_layout``) are kinds of their own;
``"f32"`` (:func:`f32`), the f32 copy of a bf16 parameter vector (LN and GN
scale and shift, biases), which the kernels read in f32 in their bf16 forms.
"""
import contextlib
import ctypes
import weakref
from typing import Callable

import torch

from . import _build

# (id(weight), kind) -> [weak reference to weight, its (data_ptr, _version,
# device), the bf16 layout, {map key: 128-byte TMA tensor map}]
_LAYOUTS: dict = {}
_RECAST: list = [None]   # under recasting(): the list of the layouts it touched


@contextlib.contextmanager
def recasting():
    """Within, every layout call launches its cast into the layout in place
    (one made before, at the weight's address; a missing one is made).
    Yields the list of every layout touched: a graph captured within keeps
    them, so a later version's new layout never frees the memory it writes."""
    before = _RECAST[0]
    touched = _RECAST[0] = []
    try:
        yield touched
    finally:
        _RECAST[0] = before


def _entry(weight: torch.Tensor, kind: str, make: Callable,
           dtype: torch.dtype = torch.bfloat16) -> list:
    """The entry of this version of ``weight``; its layout None where
    ``make(weight)`` in ``dtype`` is the weight itself (a bf16 weight's
    "linear" kind): no copy is made, and the entry holds no strong
    reference to the weight."""
    key = (weight.data_ptr(), weight._version, weight.device)
    slot = (id(weight), kind)
    entry = _LAYOUTS.get(slot)
    touched = _RECAST[0]
    if (touched is not None and entry is not None and entry[0]() is weight
            and entry[2] is not None and entry[1][0::2] == key[0::2]):
        with torch.no_grad():
            entry[2].copy_(make(weight.detach()))
        entry[1] = key
    elif entry is None or entry[0]() is not weight or entry[1] != key:
        with torch.no_grad():
            layout = make(weight.detach()).to(dtype).contiguous()
        if layout.data_ptr() == weight.data_ptr():
            layout = None
        ref = weakref.ref(weight, lambda _, slot=slot: _LAYOUTS.pop(slot, None))
        entry = _LAYOUTS[slot] = [ref, key, layout, {}]
    if touched is not None and entry[2] is not None:
        touched.append(entry[2])
    return entry


def _layout_of(entry: list, weight: torch.Tensor) -> torch.Tensor:
    return weight.detach() if entry[2] is None else entry[2]


def layout(weight: torch.Tensor, kind: str, make: Callable) -> torch.Tensor:
    """The bf16 ``make(weight)`` of this version of ``weight`` (the weight
    itself where that is already its layout)."""
    return _layout_of(_entry(weight, kind, make), weight)


def tensor_map(weight: torch.Tensor, kind: str, make: Callable, map_key, encode: Callable):
    """The layout and its tensor map ``encode(layout)``, made on first use
    and kept under ``map_key`` beside the layout."""
    entry = _entry(weight, kind, make)
    lay = _layout_of(entry, weight)
    desc = entry[3].get(map_key)
    if desc is None:
        desc = entry[3][map_key] = encode(lay)
    return lay, desc


def _same(w: torch.Tensor) -> torch.Tensor:
    return w


def f32(vector):
    """A parameter vector in f32: itself where it is f32 (or None), else its
    f32 copy (exact) of this version."""
    if vector is None or vector.dtype == torch.float32:
        return vector
    return _entry(vector, "f32", _same, torch.float32)[2]


def linear_bf16(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 copy of a ``Linear`` weight (N, K), in its own layout (a bf16
    weight as it is: no second copy)."""
    return layout(weight, "linear", _same)


def _transposed(w: torch.Tensor) -> torch.Tensor:
    return w.t()


def linear_t_bf16(weight: torch.Tensor) -> torch.Tensor:
    """The bf16 copy of a ``Linear`` weight's transpose (K, N), contiguous."""
    return layout(weight, "linear_t", _transposed)


def _map_encoder(box_rows: int, lib: ctypes.CDLL) -> Callable:
    def encode(w):
        desc = ctypes.create_string_buffer(128)
        _build.check(lib.bf16_matrix_map(_build.ptr(w), w.shape[0], w.shape[1], box_rows, desc),
                     "bf16_matrix_map")
        return desc

    return encode


def linear_map(weight: torch.Tensor, box_rows: int, lib: ctypes.CDLL):
    """The bf16 copy of a ``Linear`` weight (N, K) and its tensor map with
    boxes of 64 columns x ``box_rows`` rows, encoded by ``lib``'s
    ``bf16_matrix_map`` (every library built on ``csrc/hopper.cuh``)."""
    return tensor_map(weight, "linear", _same, box_rows, _map_encoder(box_rows, lib))


def linear_t_map(weight: torch.Tensor, box_rows: int, lib: ctypes.CDLL):
    """The bf16 copy of a ``Linear`` weight's transpose (K, N), contiguous,
    and its tensor map with boxes of 64 columns x ``box_rows`` rows."""
    return tensor_map(weight, "linear_t", _transposed, box_rows, _map_encoder(box_rows, lib))


# the argument types of bf16_matrix_map, for each library's signatures
MAP_SIGNATURE = {"bf16_matrix_map": [_build.P, _build.I, _build.I, _build.I, _build.P]}
