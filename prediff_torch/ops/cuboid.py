"""Cuboid decomposition: what the axial path needs.

``cuboid_reorder`` / ``cuboid_reorder_reverse`` serve the plain attention
version only; the CUDA kernel reads cuboids in place by strides."""
import numpy as np
import torch


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
