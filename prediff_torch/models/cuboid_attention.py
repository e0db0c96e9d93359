"""Cuboid self-attention (Earthformer's core): attention within
non-overlapping local ('l') or dilated ('d') cuboids, with Swin-style
shifted windows, padding of ragged axes and a learned relative-position
bias.

Each layer takes one of five routes, as the JAX package's
``CuboidSelfAttentionLayer._try_fused_layer`` decides (:func:`attention_route`):

- ``axial``: the cuboid spans one whole axis and is 1 on the others, with no
  shift, pad or mask: the axial kernel on the natural layout;
- ``v4``: any other cuboid of at most 256 rows (``V4_MAX_ROWS``) with no
  shift, pad or mask: ``cuboid_reorder``, the general layer kernel, reverse;
- ``grouped`` / ``grouped_masked``: every padded or shifted window, and any
  cuboid above 256 rows: LN, pad, roll, reorder and the QKV product as plain
  f32 ``nn.LayerNorm`` / ``nn.Linear`` (``nn.Dense`` outside any Pallas kernel
  in the JAX package), the grouped core kernel with the window mask (or none),
  the output ``nn.Linear``, then reverse, roll back and unpad (on bf16
  parameters all of it in bf16, the core's bf16 form, the bias in f32);
- ``grouped_einsum``: such a window in training mode with ``attn_drop`` above
  0.  The JAX package keeps its grouped kernel off this case (the kernel has
  no dropout on the weights) and computes the core with XLA einsums; here it
  is plain torch likewise: ``masked_softmax``, the attention-weight mask,
  ``p . v``, ``proj``;
- ``einsum``: an ``axial`` or ``v4`` cuboid whose width the kernels refuse
  (``ops/attention.supports_axial`` / ``supports_cuboid``: C not a multiple
  of 64, as at ``configs/tiny_smoke.yaml``'s 16 and 32): the same einsum
  code in f32 on the layer's own ``norm``, ``qkv``, relative bias and
  ``proj``, as the JAX layer runs flax's modules where its kernels refuse a
  shape.  Under dropout it takes the site and the masks the kernel route
  would (an axial layer's output mask on the natural layout).

The JAX package also gates its TPU kernels on a VMEM byte budget, on
``dim % 128 == 0`` and on ``G * vol % 8 == 0``; they choose which Pallas kernel
fits a TPU core, not what the layer computes, and the port drops them: its
axial and v4 kernels take any C that is a multiple of 64 (and raise
otherwise), its grouped core any vol.  Where such a gate sends a TPU layer
to the grouped route, the port runs the fused one, so the two differ by the
bf16 operand rounding only.  Global vectors are not ported and raise.

The configuration's ``use_pallas_attention`` picks among them as the JAX
layer's does (``prediff_tpu/ops/dispatch.py``, ``cuboid_attention.py``):
``"auto"`` and ``"layer"`` (``kernels="layer"``) the routes above; ``True``
(``kernels="grouped"``) the grouped kernel for every layer, also the axial and
v4 cuboids (``grouped_einsum`` under attention dropout); ``False`` and
``"grouped"`` (``kernels="einsum"``: the JAX layer sends ``"grouped"`` past
both of its kernel branches) the einsum code for every layer.

In training mode with a rate above 0 a layer call takes one site of the
forward's :class:`DropoutStream`: the axial and v4 routes run the dropout
kernels, the grouped routes drop the projected output (and the einsum route
the attention weights) with the masks of ``ops/dropout.py`` on the reordered
layout, where flax's ``Dropout`` acts in the JAX layer; every mask from the
stream's element base (a base the kernels do not take, not a multiple of 4,
sends an axial or v4 layer to the einsum route).
"""
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import (V4_MAX_ROWS, fused_axial_attention, fused_cuboid_attention_grouped,
                             fused_cuboid_attention_layer, supports_axial, supports_cuboid)
from ..ops.cuboid import (compute_cuboid_self_attention_mask, cuboid_reorder,
                          cuboid_reorder_reverse, masked_softmax, update_cuboid_size_shift_size)
from ..ops.dropout import (DropoutStream, apply_mask, cuboid_layer_masks, is_active,
                           kernel_bases, resolve_masks)
from ..ops.pad import generalize_padding, generalize_unpadding
from .layers import PositionwiseFFN

def attention_route(data_shape: Tuple[int, int, int], cuboid_size, shift_size, strategy,
                    padding_type: str, attn_dropout: bool = False) -> str:
    """The route a layer takes on a (T, H, W) input: "axial", "v4", "grouped"
    or "grouped_masked" (a shift always gives a mask); "grouped_einsum" for
    either grouped route under active attention-weight dropout."""
    data_shape = tuple(data_shape)
    cs, shift = update_cuboid_size_shift_size(data_shape, cuboid_size, shift_size, strategy)
    if compute_cuboid_self_attention_mask(data_shape, cs, shift, tuple(strategy),
                                          padding_type) is not None:
        route = "grouped_masked"
    elif any(n % c for n, c in zip(data_shape, cs)):
        route = "grouped"
    elif _axial_axis(cs, data_shape) is not None:
        route = "axial"
    else:
        route = "v4" if math.prod(cs) <= V4_MAX_ROWS else "grouped"
    return "grouped_einsum" if attn_dropout and route.startswith("grouped") else route


def _axial_axis(cuboid_size, data_shape) -> Optional[int]:
    """The axis a cuboid spans whole, being 1 on the others (an axial
    layer's), or None."""
    return next((ax for ax in range(3) if cuboid_size[ax] == data_shape[ax]
                 and all(cuboid_size[o] == 1 for o in range(3) if o != ax)), None)


@functools.lru_cache(maxsize=None)
def _device_mask(data_shape, cuboid_size, shift_size, strategy, padding_type,
                 device: torch.device) -> Optional[torch.Tensor]:
    """The window mask as a bool tensor on ``device`` (None: no mask), made
    once per shape."""
    mask = compute_cuboid_self_attention_mask(data_shape, cuboid_size, shift_size, strategy,
                                              padding_type)
    return None if mask is None else torch.from_numpy(mask).to(device)


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
    :class:`DropoutStream`.  ``kernels``: "layer", "grouped" or "einsum", the
    configuration's ``use_pallas_attention`` (module docstring)."""

    def __init__(self, dim: int, num_heads: int, cuboid_size=(2, 7, 7), shift_size=(0, 0, 0),
                 strategy=("l", "l", "l"), padding_type: str = "ignore",
                 attn_drop: float = 0.0, proj_drop: float = 0.0, kernels: str = "layer"):
        super().__init__()
        if kernels not in ("layer", "grouped", "einsum"):
            raise ValueError(f"kernels={kernels!r} (layer, grouped or einsum)")
        self.kernels = kernels
        self.attn_drop, self.proj_drop = attn_drop, proj_drop
        if dim % num_heads != 0:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        if padding_type not in ("ignore", "zeros", "nearest"):
            raise ValueError(f"padding_type '{padding_type}'")
        self.dim, self.num_heads = dim, num_heads
        self.cuboid_size = tuple(cuboid_size)
        self.shift_size = tuple(shift_size)
        self.strategy = tuple(strategy)
        self.padding_type = padding_type
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

    def route(self, shape, bases=(0, 0)) -> str:
        """This layer's route (:func:`attention_route`) on a (B, T, H, W, C)
        input in its current mode, under ``kernels``; "einsum" where that is
        "axial" or "v4" and the kernels refuse the width or the dropout
        masks' element ``bases``."""
        B, T, H, W, C = shape
        attn_dropout = self.training and self.attn_drop > 0.0
        route = attention_route((T, H, W), self.cuboid_size, self.shift_size, self.strategy,
                                self.padding_type, attn_dropout=attn_dropout)
        if self.kernels == "einsum":
            return "einsum" if route in ("axial", "v4") else "grouped_einsum"
        if self.kernels == "grouped" and route in ("axial", "v4"):
            return "grouped_einsum" if attn_dropout else "grouped"
        cs, _ = update_cuboid_size_shift_size((T, H, W), self.cuboid_size, self.shift_size,
                                              self.strategy)
        vol = math.prod(cs)
        if route in ("axial", "v4") and not kernel_bases(bases):
            return "einsum"
        if route == "axial" and not supports_axial(shape, _axial_axis(cs, (T, H, W)),
                                                   self.num_heads):
            return "einsum"
        if route == "v4" and not supports_cuboid(B * T * H * W // vol, vol, C, self.num_heads):
            return "einsum"
        return route

    def rel_bias(self, vol: int, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(heads, vol, vol) relative-position bias gathered from the table, in
        ``dtype`` (the kernels read it in f32, whatever the table's dtype: a
        bf16 table widens exactly) or the table's."""
        idx = self.relative_position_index[:vol, :vol].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(vol, vol, self.num_heads)
        bias = bias.permute(2, 0, 1)
        if dtype in (None, bias.dtype):
            return bias.contiguous()
        return bias.to(dtype, memory_format=torch.contiguous_format)

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None) -> torch.Tensor:
        _, T, H, W, C = x.shape
        cs, shift = update_cuboid_size_shift_size((T, H, W), self.cuboid_size, self.shift_size,
                                                  self.strategy)
        vol = math.prod(cs)
        rates = {}
        if is_active(self, drop, self.attn_drop, self.proj_drop):
            # a batch row's elements: the padded cuboids' weights, the (padded) output
            padded = math.prod(-(-n // c) * c for n, c in zip((T, H, W), cs))
            rates = dict(rate_attn=self.attn_drop, rate_proj=self.proj_drop, seed=drop.seed,
                         site=drop.next_site(),
                         bases=drop.bases(padded // vol * self.num_heads * vol * vol, padded * C))
        route = self.route(x.shape, rates.get("bases", (0, 0)))
        if route == "axial":
            return fused_axial_attention(x.contiguous(), _axial_axis(cs, (T, H, W)),
                                         self.norm.weight, self.norm.bias, self.qkv.weight,
                                         self.rel_bias(vol, torch.float32), self.proj.weight,
                                         self.proj.bias, self.num_heads, self.scale,
                                         self.norm.eps, **rates)
        if route == "v4":
            xr = cuboid_reorder(x, cs, self.strategy).contiguous()
            out = fused_cuboid_attention_layer(xr, self.norm.weight, self.norm.bias,
                                               self.qkv.weight, self.rel_bias(vol, torch.float32),
                                               self.proj.weight, self.proj.bias, self.num_heads,
                                               self.scale, self.norm.eps, **rates)
            return cuboid_reorder_reverse(out, cs, self.strategy, (T, H, W))
        natural = route == "einsum" and _axial_axis(cs, (T, H, W)) is not None
        return self._grouped(x, cs, shift, route.endswith("einsum"), rates, natural)

    def _grouped(self, x, cs, shift, einsum: bool, rates, natural_proj_mask=False) -> torch.Tensor:
        B, T, H, W, C = x.shape
        heads = self.num_heads
        pads = [(c - n % c) % c for n, c in zip((T, H, W), cs)]
        x = generalize_padding(self.norm(x), *pads, self.padding_type)
        if any(shift):
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        xr = cuboid_reorder(x, cs, self.strategy)
        _, nC, vol, _ = xr.shape
        m_a = m_p = None
        if rates and natural_proj_mask:   # the axial kernel's masks: m_p on (B, T, H, W, C)
            m_a, m_p = resolve_masks((rates["rate_attn"], rates["rate_proj"]),
                                     ((B, nC, heads, vol, vol), (B, T, H, W, C)), rates["seed"],
                                     rates["site"], None, x.device, rates["bases"])
            if m_p is not None:
                m_p = cuboid_reorder(m_p, cs, self.strategy)
        elif rates:   # tensor 0 the attention weights, tensor 1 the projected output, as flax's
            m_a, m_p = cuboid_layer_masks(xr.shape, heads, rates["rate_attn"], rates["rate_proj"],
                                          rates["seed"], rates["site"], device=x.device,
                                          bases=rates["bases"])
        qkv = self.qkv(xr).reshape(B, nC, vol, 3, heads, C // heads)
        mask = _device_mask((T, H, W), cs, shift, self.strategy, self.padding_type, x.device)
        if einsum:
            # the JAX layer's XLA einsum route (no Pallas kernel there either)
            q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
            s = torch.einsum("bnihc,bnjhc->bnhij", q * self.scale, k) + self.rel_bias(vol)
            p = masked_softmax(s, None if mask is None else mask[None, :, None])
            out = torch.einsum("bnhij,bnjhc->bnihc", apply_mask(p, m_a, self.attn_drop), v)
            out = out.reshape(B, nC, vol, C)
        else:
            qkv = qkv.permute(3, 0, 4, 1, 2, 5).contiguous()      # (3, B, heads, nC, vol, hc)
            out = fused_cuboid_attention_grouped(qkv[0], qkv[1], qkv[2],
                                                 self.rel_bias(vol, torch.float32), mask,
                                                 self.scale)
            out = out.permute(0, 2, 3, 1, 4).reshape(B, nC, vol, C)
        out = apply_mask(self.proj(out), m_p, self.proj_drop)
        x = cuboid_reorder_reverse(out, cs, self.strategy,
                                   (T + pads[0], H + pads[1], W + pads[2]))
        if any(shift):
            x = torch.roll(x, shifts=tuple(shift), dims=(1, 2, 3))
        return generalize_unpadding(x, *pads, self.padding_type)


class StackCuboidSelfAttentionBlock(nn.Module):
    """x -> x + attn_i(x) -> ffn_i, for each pattern i (``use_inter_ffn``);
    ``attention_kernels`` and ``ffn_kernel`` the layers' ``kernels`` and
    ``kernel``."""

    def __init__(self, dim: int, num_heads: int, block_cuboid_size: Sequence,
                 block_shift_size: Sequence, block_strategy: Sequence, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, ffn_drop: float = 0.0, padding_type: str = "ignore",
                 attention_kernels: str = "layer", ffn_kernel: bool = True):
        super().__init__()
        self.attn_l = nn.ModuleList([
            CuboidSelfAttentionLayer(dim, num_heads, cs, ss, st, padding_type, attn_drop,
                                     proj_drop, kernels=attention_kernels)
            for cs, ss, st in zip(block_cuboid_size, block_shift_size, block_strategy)
        ])
        self.ffn_l = nn.ModuleList([
            PositionwiseFFN(dim, 4 * dim, activation_dropout=ffn_drop, dropout=ffn_drop,
                            kernel=ffn_kernel)
            for _ in self.attn_l])

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None) -> torch.Tensor:
        for attn, ffn in zip(self.attn_l, self.ffn_l):
            x = ffn(x + attn(x, drop), drop)
        return x
