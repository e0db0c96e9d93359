"""Cuboid self-attention on the axial whole-layer path.

An axial layer attends along one whole axis (cuboid (T,1,1), (1,H,1) or
(1,1,W)), so it needs no shift, no padding and no mask; it runs as one call
of the axial attention kernel on the natural layout.  Other cuboid
patterns, shifted windows and global vectors are not ported yet and raise.
"""
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import fused_axial_attention
from ..ops.cuboid import update_cuboid_size_shift_size
from ..ops.dropout import DropoutStream, is_active
from .layers import PositionwiseFFN


@functools.lru_cache(maxsize=None)
def compute_relative_position_index(cuboid_size: Tuple[int, int, int]) -> np.ndarray:
    """(volume, volume) index into the (2bt-1)(2bh-1)(2bw-1) bias table."""
    coords = np.stack(np.meshgrid(np.arange(cuboid_size[0]), np.arange(cuboid_size[1]),
                                  np.arange(cuboid_size[2]), indexing="ij"))
    coords_flat = coords.reshape(3, -1)
    rel = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += cuboid_size[0] - 1
    rel[:, :, 1] += cuboid_size[1] - 1
    rel[:, :, 2] += cuboid_size[2] - 1
    rel[:, :, 0] *= (2 * cuboid_size[1] - 1) * (2 * cuboid_size[2] - 1)
    rel[:, :, 1] *= 2 * cuboid_size[2] - 1
    return rel.sum(-1)


class CuboidSelfAttentionLayer(nn.Module):
    """LN -> QKV (no bias) -> per-cuboid softmax(q k^T scale + relbias) v ->
    proj, with no residual; the block adds it.  In training mode with a rate
    above 0 (``attn_drop`` on the attention weights, ``proj_drop`` on the
    projected output) the call takes the next site of the forward's
    :class:`DropoutStream` and runs the dropout kernels."""

    def __init__(self, dim: int, num_heads: int, cuboid_size=(2, 7, 7), shift_size=(0, 0, 0),
                 strategy=("l", "l", "l"), attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.dim, self.num_heads = dim, num_heads
        self.cuboid_size = tuple(cuboid_size)
        self.shift_size = tuple(shift_size)
        self.strategy = tuple(strategy)
        self.scale = (dim // num_heads) ** -0.5
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.proj = nn.Linear(dim, dim)
        table_len = ((2 * self.cuboid_size[0] - 1) * (2 * self.cuboid_size[1] - 1)
                     * (2 * self.cuboid_size[2] - 1))
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_len, num_heads))
        rel_idx = compute_relative_position_index(self.cuboid_size)
        self.register_buffer("relative_position_index", torch.from_numpy(rel_idx.astype(np.int64)),
                             persistent=False)

    def _axis(self, shape) -> int:
        _, T, H, W, _ = shape
        cs, shift = update_cuboid_size_shift_size((T, H, W), self.cuboid_size, self.shift_size,
                                                  self.strategy)
        if any(shift):
            raise NotImplementedError("shifted cuboid windows are not ported yet")
        for axis, axial in enumerate(((T, 1, 1), (1, H, 1), (1, 1, W))):
            if cs == axial:
                return axis
        raise NotImplementedError(f"cuboid {cs} on {(T, H, W)} is not an axial pattern")

    def rel_bias(self, vol: int) -> torch.Tensor:
        """(heads, vol, vol) relative-position bias gathered from the table."""
        idx = self.relative_position_index[:vol, :vol].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(vol, vol, self.num_heads)
        return bias.permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None) -> torch.Tensor:
        axis = self._axis(x.shape)
        vol = x.shape[1 + axis]
        rates = {}
        if is_active(self, drop, self.attn_drop, self.proj_drop):
            rates = dict(rate_attn=self.attn_drop, rate_proj=self.proj_drop, seed=drop.seed,
                         site=drop.next_site())
        return fused_axial_attention(x.contiguous(), axis, self.norm.weight, self.norm.bias,
                                     self.qkv.weight, self.rel_bias(vol), self.proj.weight,
                                     self.proj.bias, self.num_heads, self.scale, self.norm.eps,
                                     **rates)


class StackCuboidSelfAttentionBlock(nn.Module):
    """x -> x + attn_i(x) -> ffn_i, for each pattern i (``use_inter_ffn``)."""

    def __init__(self, dim: int, num_heads: int, block_cuboid_size: Sequence,
                 block_shift_size: Sequence, block_strategy: Sequence, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, ffn_drop: float = 0.0):
        super().__init__()
        self.attn_l = nn.ModuleList([
            CuboidSelfAttentionLayer(dim, num_heads, cs, ss, st, attn_drop, proj_drop)
            for cs, ss, st in zip(block_cuboid_size, block_shift_size, block_strategy)
        ])
        self.ffn_l = nn.ModuleList([
            PositionwiseFFN(dim, 4 * dim, activation_dropout=ffn_drop, dropout=ffn_drop)
            for _ in self.attn_l])

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None) -> torch.Tensor:
        for attn, ffn in zip(self.attn_l, self.ffn_l):
            x = ffn(x + attn(x, drop), drop)
        return x
