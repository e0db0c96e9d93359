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
bf16 operand rounding only.

The layer's variants, as the JAX layer builds them: ``use_relative_pos=False``
(no bias table: every route takes a zero (heads, vol, vol) bias, as both JAX
kernel branches do); ``use_final_proj=False`` (no ``proj``: the whole-layer
kernels do not take the layer, as in the JAX layer, so an ``axial`` or ``v4``
cuboid takes the ``grouped`` route, ``grouped_einsum`` under attention
dropout, without the projection or its dropout); and global vectors
(``use_global_vector``: l2g / g2l / g2g attention with ``global_vec_norm``,
the shared ``global_qkv`` or the six nets of ``separate_global_qkv``,
``use_global_self_attn``, ``global_dim_ratio``, ``global_proj``), which take
no attention kernel in the JAX package and here the einsum code
(:meth:`CuboidSelfAttentionLayer._global`).  Under dropout a global layer
call takes two sites: the local weights (over the cuboid's keys and the
global vectors) and the projected output, then the global weights and the
global projection's output.

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
from .init import with_init
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
                 attn_drop: float = 0.0, proj_drop: float = 0.0, kernels: str = "layer",
                 use_relative_pos: bool = True, use_final_proj: bool = True,
                 use_global_vector: bool = False, use_global_self_attn: bool = False,
                 separate_global_qkv: bool = False, global_dim_ratio: int = 1,
                 attn_linear_init_mode: str = "0", proj_linear_init_mode: str = "2"):
        super().__init__()
        if global_dim_ratio != 1 and not separate_global_qkv:
            raise ValueError("global_dim_ratio != 1 needs separate_global_qkv=True")
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
        self.use_relative_pos, self.use_final_proj = use_relative_pos, use_final_proj
        self.use_global_vector = use_global_vector
        self.use_global_self_attn = use_global_self_attn
        self.norm = nn.LayerNorm(dim, eps=1e-5)

        def linear(i, o, bias=False, mode=attn_linear_init_mode):
            return with_init(nn.Linear(i, o, bias=bias), mode)

        self.qkv = linear(dim, 3 * dim)
        gC = global_dim_ratio * dim
        self.global_dim = gC
        if use_global_vector:
            self.global_vec_norm = nn.LayerNorm(gC, eps=1e-5)
            self.separate_global_qkv = separate_global_qkv
            if separate_global_qkv:
                self.l2g_q_net = linear(dim, dim)
                self.l2g_global_kv_net = linear(gC, 2 * dim)
                self.g2l_global_q_net = linear(gC, dim)
                self.g2l_k_net = linear(dim, dim)
                self.g2l_v_net = linear(dim, gC)
                if use_global_self_attn:
                    self.g2g_global_qkv_net = linear(gC, 3 * gC)
            else:
                self.global_qkv = linear(dim, 3 * dim)
        if use_final_proj:
            self.proj = linear(dim, dim, True, proj_linear_init_mode)
            if use_global_vector:
                self.global_proj = linear(gC, gC, True, proj_linear_init_mode)
        if use_relative_pos:
            table_len = ((2 * self.cuboid_size[0] - 1) * (2 * self.cuboid_size[1] - 1)
                         * (2 * self.cuboid_size[2] - 1))
            self.relative_position_bias_table = nn.Parameter(torch.zeros(table_len, num_heads))
            rel_idx = compute_relative_position_index(self.cuboid_size)
            self.register_buffer("relative_position_index",
                                 torch.from_numpy(rel_idx.astype(np.int64)), persistent=False)

    def route(self, shape, bases=(0, 0)) -> str:
        """This layer's route (:func:`attention_route`) on a (B, T, H, W, C)
        input in its current mode, under ``kernels``; "einsum" where that is
        "axial" or "v4" and the kernels refuse the width or the dropout
        masks' element ``bases``; "global" (the einsum code with the global
        vectors) for a layer that has them."""
        B, T, H, W, C = shape
        attn_dropout = self.training and self.attn_drop > 0.0
        route = attention_route((T, H, W), self.cuboid_size, self.shift_size, self.strategy,
                                self.padding_type, attn_dropout=attn_dropout)
        if self.use_global_vector:
            return "global"
        if self.kernels == "einsum":
            return "einsum" if route in ("axial", "v4") else "grouped_einsum"
        if route in ("axial", "v4") and (self.kernels == "grouped" or not self.use_final_proj):
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
        bf16 table widens exactly) or the table's; zeros without a table
        (``use_relative_pos=False``), in ``dtype`` or the layer's."""
        if not self.use_relative_pos:
            w = self.qkv.weight
            return torch.zeros((self.num_heads, vol, vol), dtype=dtype or w.dtype,
                               device=w.device)
        idx = self.relative_position_index[:vol, :vol].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(vol, vol, self.num_heads)
        bias = bias.permute(2, 0, 1)
        if dtype in (None, bias.dtype):
            return bias.contiguous()
        return bias.to(dtype, memory_format=torch.contiguous_format)

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None,
                global_vectors: Optional[torch.Tensor] = None):
        """x (B, T, H, W, C) -> the layer's output; with global vectors
        (B, N, global_dim) also given, (output, new global vectors)."""
        _, T, H, W, C = x.shape
        cs, shift = update_cuboid_size_shift_size((T, H, W), self.cuboid_size, self.shift_size,
                                                  self.strategy)
        vol = math.prod(cs)
        if self.use_global_vector:
            if global_vectors is None:
                raise ValueError("a layer with global vectors needs them")
            return self._global(x, global_vectors, cs, shift, drop)
        rates = {}
        # without a final projection there is no projection dropout, as in the JAX layer
        rate_proj = self.proj_drop if self.use_final_proj else 0.0
        if is_active(self, drop, self.attn_drop, rate_proj):
            # a batch row's elements: the padded cuboids' weights, the (padded) output
            padded = math.prod(-(-n // c) * c for n, c in zip((T, H, W), cs))
            rates = dict(rate_attn=self.attn_drop, rate_proj=rate_proj, seed=drop.seed,
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
        if self.use_final_proj:
            out = apply_mask(self.proj(out), m_p, self.proj_drop)
        return self._unreorder(out, cs, shift, pads, (T, H, W))

    def _unreorder(self, out, cs, shift, pads, dims):
        """The reordered (B, cuboids, vol, C') output back to (B, T, H, W, C'):
        reverse the reorder, roll back, unpad."""
        T, H, W = dims
        x = cuboid_reorder_reverse(out, cs, self.strategy,
                                   (T + pads[0], H + pads[1], W + pads[2]))
        if any(shift):
            x = torch.roll(x, shifts=tuple(shift), dims=(1, 2, 3))
        return generalize_unpadding(x, *pads, self.padding_type)

    def _global(self, x, gv, cs, shift, drop):
        """The layer with global vectors (the JAX layer's einsum code,
        ``prediff_tpu/models/cuboid_attention.py`` :360-478): local queries
        attend over their cuboid and the N global vectors (l2g), each global
        vector over every local cell (g2l) and, with
        ``use_global_self_attn``, over the global vectors too (g2g).  Under
        ``padding_type="ignore"`` the g2l mask is the JAX layer's: the
        padded, rolled grid flattened in its natural order."""
        B, T, H, W, C = x.shape
        heads = self.num_heads
        hc, gC = C // heads, self.global_dim
        ghc = gC // heads
        N = gv.shape[1]
        pads = [(c - n % c) % c for n, c in zip((T, H, W), cs)]
        x = generalize_padding(self.norm(x), *pads, self.padding_type)
        gv = self.global_vec_norm(gv)
        if any(shift):
            x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        xr = cuboid_reorder(x, cs, self.strategy)
        _, nC, vol, _ = xr.shape
        L = nC * vol
        m_a = m_p = m_ga = m_gp = None
        rate_proj = self.proj_drop if self.use_final_proj else 0.0
        if is_active(self, drop, self.attn_drop, rate_proj):
            per_row = (nC * heads * vol * (vol + N), L * C)
            m_a, m_p = resolve_masks((self.attn_drop, rate_proj),
                                     ((B, nC, heads, vol, vol + N), (B, nC, vol, C)), drop.seed,
                                     drop.next_site(), None, x.device, drop.bases(*per_row))
            L_all = L + N if self.use_global_self_attn else L
            m_ga, m_gp = resolve_masks((self.attn_drop, rate_proj),
                                       ((B, heads, N, L_all), (B, N, gC)), drop.seed,
                                       drop.next_site(), None, x.device,
                                       drop.bases(heads * N * L_all, N * gC))
        mask = _device_mask((T, H, W), cs, shift, self.strategy, self.padding_type, x.device)
        qkv = self.qkv(xr).reshape(B, nC, vol, 3, heads, hc)
        q, k, v = qkv[..., 0, :, :] * self.scale, qkv[..., 1, :, :], qkv[..., 2, :, :]
        s = torch.einsum("bnihc,bnjhc->bnhij", q, k)
        if self.use_relative_pos:
            s = s + self.rel_bias(vol)
        if self.separate_global_qkv:
            l2g_q = self.l2g_q_net(xr).reshape(B, nC, vol, heads, hc) * self.scale
            l2g_kv = self.l2g_global_kv_net(gv).reshape(B, N, 2, heads, hc)
            l2g_k, l2g_v = l2g_kv[:, :, 0], l2g_kv[:, :, 1]
            g2l_q = self.g2l_global_q_net(gv).reshape(B, N, heads, hc) * self.scale
            g2l_k = self.g2l_k_net(xr).reshape(B, nC, vol, heads, hc)
            g2l_v = self.g2l_v_net(xr).reshape(B, nC, vol, heads, ghc)
            if self.use_global_self_attn:
                g2g = self.g2g_global_qkv_net(gv).reshape(B, N, 3, heads, ghc)
                g2g_q, g2g_k, g2g_v = g2g[:, :, 0] * self.scale, g2g[:, :, 1], g2g[:, :, 2]
        else:
            qkv_g = self.global_qkv(gv).reshape(B, N, 3, heads, hc)
            q_g, k_g, v_g = qkv_g[:, :, 0] * self.scale, qkv_g[:, :, 1], qkv_g[:, :, 2]
            l2g_q, g2l_k, g2l_v = q, k, v
            g2l_q, l2g_k, l2g_v = q_g, k_g, v_g
            g2g_q, g2g_k, g2g_v = q_g, k_g, v_g
        # local queries over the cuboid's keys and the global vectors
        s = torch.cat([s, torch.einsum("bnihc,bghc->bnhig", l2g_q, l2g_k)], dim=-1)
        if mask is not None:
            mask = torch.cat([mask[None, :, None],
                              mask.new_ones((1, nC, 1, vol, N))], dim=-1)
        v_lg = torch.cat([v, l2g_v[:, None].expand(B, nC, N, heads, hc)], dim=2)
        p = apply_mask(masked_softmax(s, mask), m_a, self.attn_drop)
        out = torch.einsum("bnhij,bnjhc->bnihc", p, v_lg).reshape(B, nC, vol, C)
        # the global vectors over every local cell (and each other)
        g_mask = None
        if self.padding_type == "ignore":
            g_mask = _g2l_mask((T, H, W), tuple(pads), tuple(shift), x.device)
        s_g = torch.einsum("bghc,blhc->bhgl", g2l_q, g2l_k.reshape(B, L, heads, hc))
        v_g = g2l_v.reshape(B, L, heads, ghc)
        if self.use_global_self_attn:
            s_g = torch.cat([s_g, torch.einsum("bghc,bkhc->bhgk", g2g_q, g2g_k)], dim=-1)
            if g_mask is not None:
                g_mask = torch.cat([g_mask, g_mask.new_ones(N)])
            v_g = torch.cat([v_g, g2g_v.reshape(B, N, heads, ghc)], dim=1)
        w = apply_mask(masked_softmax(s_g, g_mask), m_ga, self.attn_drop)
        new_gv = torch.einsum("bhgl,blhc->bghc", w, v_g).reshape(B, N, gC)
        if self.use_final_proj:
            out = apply_mask(self.proj(out), m_p, self.proj_drop)
            new_gv = apply_mask(self.global_proj(new_gv), m_gp, self.proj_drop)
        return self._unreorder(out, cs, shift, pads, (T, H, W)), new_gv


@functools.lru_cache(maxsize=None)
def _g2l_mask(data_shape, pads, shift, device: torch.device) -> torch.Tensor:
    """The JAX layer's g2l mask under ``padding_type="ignore"``: ones over the
    (T, H, W) grid, zeros over its padding, rolled back by the shift and
    flattened in the grid's natural order (the keys it masks are in the
    cuboid order, as in the JAX layer and Earthformer)."""
    m = np.pad(np.ones(data_shape, dtype=bool), [(0, p) for p in pads])
    if any(shift):
        m = np.roll(m, shift=tuple(-s for s in shift), axis=(0, 1, 2))
    return torch.from_numpy(m.reshape(-1)).to(device)


class StackCuboidSelfAttentionBlock(nn.Module):
    """x -> x + attn_i(x) -> ffn_i, for each pattern i (``use_inter_ffn``),
    or x -> x + attn_i(x) for every i, then one FFN (``use_inter_ffn=False``);
    with global vectors each attention also updates them (+ residual) and
    ``global_ffn_l`` (``use_global_vector_ffn``) follows each FFN on them,
    always on the library route (the JAX package gives the global FFNs no
    kernel).  ``attention_kernels`` and ``ffn_kernel`` are the layers'
    ``kernels`` and ``kernel``; ``activation`` and ``gated_ffn`` the FFNs'."""

    def __init__(self, dim: int, num_heads: int, block_cuboid_size: Sequence,
                 block_shift_size: Sequence, block_strategy: Sequence, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, ffn_drop: float = 0.0, padding_type: str = "ignore",
                 attention_kernels: str = "layer", ffn_kernel: bool = True,
                 activation: str = "gelu", gated_ffn: bool = False, use_inter_ffn: bool = True,
                 use_global_vector: bool = False, use_global_vector_ffn: bool = True,
                 use_global_self_attn: bool = False, separate_global_qkv: bool = False,
                 global_dim_ratio: int = 1, use_relative_pos: bool = True,
                 use_final_proj: bool = True, attn_linear_init_mode: str = "0",
                 ffn_linear_init_mode: str = "0", ffn2_linear_init_mode: str = "2",
                 attn_proj_linear_init_mode: str = "2"):
        super().__init__()
        self.use_inter_ffn = use_inter_ffn
        self.use_global_vector = use_global_vector
        self.attn_l = nn.ModuleList([
            CuboidSelfAttentionLayer(
                dim, num_heads, cs, ss, st, padding_type, attn_drop, proj_drop,
                kernels=attention_kernels, use_relative_pos=use_relative_pos,
                use_final_proj=use_final_proj, use_global_vector=use_global_vector,
                use_global_self_attn=use_global_self_attn,
                separate_global_qkv=separate_global_qkv, global_dim_ratio=global_dim_ratio,
                attn_linear_init_mode=attn_linear_init_mode,
                proj_linear_init_mode=attn_proj_linear_init_mode)
            for cs, ss, st in zip(block_cuboid_size, block_shift_size, block_strategy)
        ])
        num_ffn = len(self.attn_l) if use_inter_ffn else 1

        def ffn(units, kernel):
            return PositionwiseFFN(units, 4 * units, activation_dropout=ffn_drop,
                                   dropout=ffn_drop, kernel=kernel, activation=activation,
                                   gated_proj=gated_ffn, linear_init_mode=ffn_linear_init_mode,
                                   ffn2_linear_init_mode=ffn2_linear_init_mode)

        self.ffn_l = nn.ModuleList([ffn(dim, ffn_kernel) for _ in range(num_ffn)])
        if use_global_vector and use_global_vector_ffn:
            self.global_ffn_l = nn.ModuleList(
                [ffn(global_dim_ratio * dim, False) for _ in range(num_ffn)])

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None,
                global_vectors: Optional[torch.Tensor] = None):
        """x, or (x, global vectors) when the block has them."""
        gv = global_vectors
        for i, attn in enumerate(self.attn_l):
            if self.use_global_vector:
                dx, dg = attn(x, drop, gv)
                x, gv = x + dx, gv + dg
            else:
                x = x + attn(x, drop)
            if self.use_inter_ffn or i == len(self.attn_l) - 1:
                j = i if self.use_inter_ffn else 0
                x = self.ffn_l[j](x, drop)
                if hasattr(self, "global_ffn_l"):
                    gv = self.global_ffn_l[j](gv, drop)
        return (x, gv) if self.use_global_vector else x
