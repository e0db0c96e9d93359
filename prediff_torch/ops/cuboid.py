"""Cuboid decomposition: the reorder into (B, cuboids, volume, C) and back,
the clamp of cuboid and shift sizes to small inputs, and the shifted-window
and padding attention mask with its masked softmax.

The axial kernel reads cuboids in place by strides; the other cuboid
layers (``models/cuboid_attention.py``) reorder first, as the JAX package
does.  The mask depends only on static shapes: it is built once in numpy
and cached.
"""
import functools
from typing import Optional, Tuple

import numpy as np
import torch

# the finite "minus infinity" of a masked score: a fully masked row then
# softmaxes to a uniform row, which the mask multiplies to 0 (never NaN)
NEG_INF = -1e18


def update_cuboid_size_shift_size(data_shape, cuboid_size, shift_size, strategy):
    """Clamp cuboid/shift sizes for small inputs; dilated axes never shift."""
    new_cuboid_size = list(cuboid_size)
    new_shift_size = list(shift_size)
    for i in range(len(data_shape)):
        if strategy[i] == "d":
            new_shift_size[i] = 0
        if data_shape[i] <= cuboid_size[i]:
            new_cuboid_size[i] = data_shape[i]
            new_shift_size[i] = 0
    return tuple(new_cuboid_size), tuple(new_shift_size)


def _split_plan(cuboid_size, sizes, strategy):
    """8-D view of (B, T, H, W, C) separating cuboid counters from offsets
    ('l': the counter is the outer factor; 'd': the inner one), and the
    permutation that moves all counters before all offsets."""
    split_shape = [None] * 8
    counter_dims, offset_dims = [], []
    for ax, (block, total, how) in enumerate(zip(cuboid_size, sizes, strategy)):
        lo, hi = 2 * ax + 1, 2 * ax + 2
        if how == "l":
            split_shape[lo], split_shape[hi] = total // block, block
            counter_dims.append(lo)
            offset_dims.append(hi)
        elif how == "d":
            split_shape[lo], split_shape[hi] = block, total // block
            counter_dims.append(hi)
            offset_dims.append(lo)
        else:
            raise NotImplementedError(f"strategy '{how}'")
    return split_shape, (0, *counter_dims, *offset_dims, 7)


def cuboid_reorder(data: torch.Tensor, cuboid_size, strategy) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, num_cuboids, cuboid_volume, C)."""
    B, T, H, W, C = data.shape
    split_shape, perm = _split_plan(cuboid_size, (T, H, W), strategy)
    split_shape[0], split_shape[7] = B, C
    x = data.reshape(tuple(split_shape)).permute(perm)
    volume = cuboid_size[0] * cuboid_size[1] * cuboid_size[2]
    return x.reshape(B, (T * H * W) // volume, volume, C)


def cuboid_reorder_reverse(data: torch.Tensor, cuboid_size, strategy, orig_data_shape) -> torch.Tensor:
    """Inverse of :func:`cuboid_reorder`."""
    B, _, _, C = data.shape
    T, H, W = orig_data_shape
    split_shape, fwd_perm = _split_plan(cuboid_size, (T, H, W), strategy)
    split_shape[0], split_shape[7] = B, C
    counters_then_offsets = tuple(split_shape[d] for d in fwd_perm)
    inv_perm = tuple(int(i) for i in np.argsort(fwd_perm))
    return data.reshape(counters_then_offsets).permute(inv_perm).reshape(B, T, H, W, C)


@functools.lru_cache(maxsize=None)
def compute_cuboid_self_attention_mask(data_shape: Tuple[int, int, int],
                                       cuboid_size: Tuple[int, int, int],
                                       shift_size: Tuple[int, int, int],
                                       strategy: Tuple[str, str, str],
                                       padding_type: str) -> Optional[np.ndarray]:
    """Shifted-window and padding attention mask, a bool numpy array
    (num_cuboids, volume, volume), or None when it would be all True (no
    shift, and the padding, if any, may be attended).

    Two cells attend to each other only if they lie in the same pre-roll
    window on every axis: along a shifted axis of padded length S with
    cuboid b and shift s, the cells fall into the bands [0, S-b), [S-b, S-s)
    and [S-s, S).  With ``padding_type="ignore"`` no cell attends to a pad
    cell.  Treat the result as read-only: it is cached."""
    T, H, W = data_shape
    pads = [(c - n % c) % c for n, c in zip(data_shape, cuboid_size)]
    any_pad = any(p > 0 for p in pads)
    any_shift = any(s > 0 for s in shift_size)
    if not any_shift and (padding_type != "ignore" or not any_pad):
        return None
    padded = (T + pads[0], H + pads[1], W + pads[2])

    def reorder(a):
        return cuboid_reorder(torch.from_numpy(a[None, ..., None]), cuboid_size,
                              strategy)[0, :, :, 0].numpy()

    def band_ids(size, block, shift):
        ids = np.zeros(size, dtype=np.int64)
        if shift > 0:
            ids[size - block:] = 1
            ids[size - shift:] = 2
        return ids

    tb, hb, wb = (band_ids(n, c, s) for n, c, s in zip(padded, cuboid_size, shift_size))
    region = reorder(tb[:, None, None] * 9 + hb[None, :, None] * 3 + wb[None, None, :])
    mask = region[:, None, :] == region[:, :, None]
    if padding_type == "ignore":
        data = np.pad(np.ones((T, H, W), dtype=bool), [(0, p) for p in pads])
        if any_shift:
            data = np.roll(data, shift=tuple(-s for s in shift_size), axis=(0, 1, 2))
        data = reorder(data)
        mask = data[:, None, :] & data[:, :, None] & mask
    return np.ascontiguousarray(mask)


def masked_softmax(att_score: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Softmax in which masked (False) entries get weight 0: their scores
    become ``NEG_INF`` before the softmax and the result is multiplied by
    the mask after it, so a fully masked row gives 0.  ``mask`` broadcasts
    against ``att_score``."""
    if mask is None:
        return torch.softmax(att_score, dim=dim)
    att_score = torch.where(mask, att_score, torch.full_like(att_score, NEG_INF))
    return torch.softmax(att_score, dim=dim) * mask
