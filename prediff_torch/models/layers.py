"""UNet building blocks, channel-last NTHWC at every public function.

Attribute paths follow the reference PyTorch names (``in_layers.0``,
``emb_layers.1``, ``layer.0``...), so the weight bridge maps them to the
flax tree mechanically (``utils/convert.py``).  Convolutions permute to
NCTHW (channels-last strides, no copy) only around the ``conv3d`` call.
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import ffn as ffn_ops, groupnorm as gn_ops, resblock as resblock_ops
from ..ops.conv3d import fused_conv3x3x3, supports_shape
from ..ops.dropout import (DropoutStream, apply_mask, is_active, keep_mask, kernel_bases,
                           resolve_masks)
from ..ops.ffn import ACTIVATIONS, fused_ffn
from ..ops.groupnorm import fused_groupnorm_silu
from ..ops.pad import generalize_padding
from ..ops.resblock import fused_resblock
from .init import with_init


def _leaky(x: torch.Tensor) -> torch.Tensor:
    """leaky ReLU of slope 0.1 as ``jax.nn.leaky_relu`` writes it (its
    gradient at 0 is 1)."""
    return torch.where(x >= 0.0, x, 0.1 * x)


_ACTIVATION_TABLE = {
    "leaky": _leaky, "elu": F.elu, "gelu": F.gelu, "relu": F.relu, "sigmoid": torch.sigmoid,
    "tanh": torch.tanh, "softrelu": F.softplus, "softplus": F.softplus, "softsign": F.softsign,
    "silu": F.silu, "swish": F.silu,
}


def get_activation(act: Optional[str]):
    """The activation of a name, the JAX package's table
    (``prediff_tpu/models/layers.py`` ``get_activation``): None and
    "identity" the identity, "gelu" the exact erf form, "leaky" slope 0.1,
    "softrelu" softplus, "swish" SiLU; any other name raises."""
    if act is None or act == "identity":
        return lambda x: x
    if act not in _ACTIVATION_TABLE:
        raise NotImplementedError(f"activation '{act}'")
    return _ACTIVATION_TABLE[act]


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings: (B,) -> (B, dim); cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def conv_nthwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NC... convolution to a channel-last tensor."""
    nd = x.ndim
    to_first = (0, nd - 1) + tuple(range(1, nd - 1))
    to_last = (0,) + tuple(range(2, nd)) + (1,)
    return conv(x.permute(to_first)).permute(to_last)


def nearest_resize_2d(x: torch.Tensor, H_new: int, W_new: int) -> torch.Tensor:
    """Nearest resize over H, W of (..., H, W, C), index floor(i * in / out)."""
    H, W = x.shape[-3], x.shape[-2]
    h_idx = (torch.arange(H_new, device=x.device) * H) // H_new
    w_idx = (torch.arange(W_new, device=x.device) * W) // W_new
    return x[..., h_idx, :, :][..., w_idx, :]


class PosEmbed(nn.Module):
    """Learned position embeddings added to (B,T,H,W,C): "t+h+w" one table
    per axis, "t+hw" a T table and one over the maxH x maxW plane (row
    h * maxW + w)."""

    def __init__(self, embed_dim: int, maxT: int, maxH: int, maxW: int, typ: str = "t+h+w"):
        super().__init__()
        if typ not in ("t+h+w", "t+hw"):
            raise ValueError(f"pos embed '{typ}' (t+h+w or t+hw)")
        self.typ, self.embed_dim, self.maxW = typ, embed_dim, maxW
        self.T_embed = nn.Embedding(maxT, embed_dim)
        if typ == "t+hw":
            self.HW_embed = nn.Embedding(maxH * maxW, embed_dim)
        else:
            self.H_embed = nn.Embedding(maxH, embed_dim)
            self.W_embed = nn.Embedding(maxW, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, T, H, W, _ = x.shape
        d = self.embed_dim
        t_emb = self.T_embed.weight[:T].reshape(T, 1, 1, d)
        if self.typ == "t+hw":
            rows = self.HW_embed.weight.reshape(-1, self.maxW, d)[:H, :W]
            return x + t_emb + rows
        return (x + t_emb + self.H_embed.weight[:H].reshape(1, H, 1, d)
                + self.W_embed.weight[:W].reshape(1, 1, W, d))


class PositionwiseFFN(nn.Module):
    """Pre-norm FFN with residual, through the fused FFN kernel where it
    takes the width (``ops/ffn.supports_shape``), else through the layer's
    own library ops in f32 (``layer_norm``, ``ffn_1``, the activation,
    ``ffn_2``, + x), as the JAX package's FFN leaves its kernel for flax's
    modules; the route depends on the shape alone, and ``kernel=False`` (the
    configuration's ``use_pallas_ffn: false``) takes the library route
    everywhere.  ``activation`` is a name of :func:`get_activation`; the
    kernel takes those of ``ops/ffn.ACTIVATIONS`` (gelu, relu, leaky, silu),
    the others take the library route, as the JAX FFN's ``_try_fused``
    decides.  ``gated_proj`` (a gated FFN, ``act(ffn_1_gate(x)) * ffn_1(x)``)
    always takes the library route, as there.  In training mode with a rate
    above 0 (``activation_dropout`` on act(h), ``dropout`` on the output
    before the residual) the call takes
    the next site of the forward's :class:`DropoutStream`: the kernel route
    runs the dropout kernels, the library route multiplies in the same masks
    (tensor 0 (tokens, hidden), tensor 1 (tokens, C)), each from the
    stream's element base; a base the kernels do not take (not a multiple of
    4) sends the call to the library route."""

    def __init__(self, units: int, hidden_size: int, layer_norm_eps: float = 1e-5,
                 activation_dropout: float = 0.0, dropout: float = 0.0, kernel: bool = True,
                 activation: str = "gelu", gated_proj: bool = False,
                 linear_init_mode: str = "0", ffn2_linear_init_mode: str = "2"):
        super().__init__()
        self.activation = activation
        self.act = get_activation(activation)
        # the kernel computes the non-gated FFN on its four activations
        self.kernel = kernel and not gated_proj and activation in ACTIVATIONS
        self.eps = layer_norm_eps
        self.activation_dropout, self.dropout = activation_dropout, dropout
        self.layer_norm = nn.LayerNorm(units, eps=layer_norm_eps)
        self.ffn_1 = with_init(nn.Linear(units, hidden_size), linear_init_mode)
        if gated_proj:
            self.ffn_1_gate = with_init(nn.Linear(units, hidden_size), linear_init_mode)
        self.ffn_2 = with_init(nn.Linear(hidden_size, units), ffn2_linear_init_mode)

    def forward(self, x: torch.Tensor, drop: Optional[DropoutStream] = None) -> torch.Tensor:
        C = x.shape[-1]
        x2 = x.reshape(-1, C)
        hidden = self.ffn_1.out_features
        rates = {}
        if is_active(self, drop, self.activation_dropout, self.dropout):
            rows = x2.shape[0] // x.shape[0]   # tokens per batch row
            rates = dict(rate_act=self.activation_dropout, rate_out=self.dropout, seed=drop.seed,
                         site=drop.next_site(), bases=drop.bases(rows * hidden, rows * C))
        if (not self.kernel or not ffn_ops.supports_shape(x2.shape[0], C, hidden)
                or not kernel_bases(rates.get("bases", ()))):
            return self._library(x2, **rates).reshape(x.shape)
        out = fused_ffn(x2.contiguous(), self.layer_norm.weight, self.layer_norm.bias,
                        self.ffn_1.weight, self.ffn_1.bias, self.ffn_2.weight, self.ffn_2.bias,
                        self.eps, **rates, activation=self.activation)
        return out.reshape(x.shape)

    def _library(self, x: torch.Tensor, rate_act: float = 0.0, rate_out: float = 0.0,
                 seed: Optional[int] = None, site: int = 0, bases=(0, 0)) -> torch.Tensor:
        m1, m2 = resolve_masks((rate_act, rate_out), ((x.shape[0], self.ffn_1.out_features),
                                                      tuple(x.shape)), seed, site, None, x.device,
                               bases)
        ln = self.layer_norm(x)
        if hasattr(self, "ffn_1_gate"):
            h = self.act(self.ffn_1_gate(ln)) * self.ffn_1(ln)
        else:
            h = self.act(self.ffn_1(ln))
        h = apply_mask(h, m1, rate_act)
        return x + apply_mask(self.ffn_2(h), m2, rate_out)


class PatchMerging3D(nn.Module):
    """Fold a (dT,dH,dW) neighbourhood into channels, then LayerNorm + Linear."""

    def __init__(self, dim: int, out_dim: int, downsample=(1, 2, 2), padding_type: str = "nearest",
                 linear_init_mode: str = "0"):
        super().__init__()
        self.downsample = tuple(downsample)
        self.padding_type = padding_type
        self.norm = nn.LayerNorm(self.downsample[0] * self.downsample[1] * self.downsample[2] * dim,
                                 eps=1e-5)
        self.reduction = with_init(nn.Linear(self.norm.normalized_shape[0], out_dim, bias=False),
                                   linear_init_mode)

    @staticmethod
    def get_out_shape(data_shape, downsample, out_dim):
        T, H, W, _ = data_shape
        pads = [(d - s % d) % d for s, d in zip((T, H, W), downsample)]
        return ((T + pads[0]) // downsample[0], (H + pads[1]) // downsample[1],
                (W + pads[2]) // downsample[2], out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        dT, dH, dW = self.downsample
        pad_t, pad_h, pad_w = (dT - T % dT) % dT, (dH - H % dH) % dH, (dW - W % dW) % dW
        if pad_t or pad_h or pad_w:
            x = generalize_padding(x, pad_t, pad_h, pad_w, self.padding_type)
            T, H, W = T + pad_t, H + pad_h, W + pad_w
        x = x.reshape(B, T // dT, dT, H // dH, dH, W // dW, dW, C)
        x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, T // dT, H // dH, W // dW, dT * dH * dW * C)
        return self.reduction(self.norm(x))


class Upsample3DLayer(nn.Module):
    """Nearest 2-D upsample to ``target_size`` + a k x k conv, per frame."""

    def __init__(self, dim: int, out_dim: int, target_size, kernel_size: int = 3,
                 conv_init_mode: str = "0"):
        super().__init__()
        self.target_size = tuple(target_size)
        self.out_dim = out_dim
        self.conv = with_init(nn.Conv2d(dim, out_dim, kernel_size, padding=kernel_size // 2),
                              conv_init_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        Tt, Ht, Wt = self.target_size
        if Tt != T:
            raise ValueError("temporal upsampling is not supported")
        x = nearest_resize_2d(x, Ht, Wt).reshape(B * T, Ht, Wt, C)
        return conv_nthwc(self.conv, x).reshape(B, T, Ht, Wt, self.out_dim)


class TimeEmbedLayer(nn.Module):
    """Two-layer SiLU MLP over the sinusoidal timestep embedding."""

    def __init__(self, base_channels: int, time_embed_channels: int):
        super().__init__()
        self.layer = nn.Sequential(nn.Linear(base_channels, time_embed_channels), nn.SiLU(),
                                   nn.Linear(time_embed_channels, time_embed_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class TimeEmbedResBlock(nn.Module):
    """Residual block with the timestep embedding folded into its second
    GroupNorm (the non-scale-shift path, no up/down resampling).  Both
    GroupNorm+SiLU go through the GN kernel; the 3x3x3 convs are
    ``conv3d`` in f32 or, with ``conv_kernel=True`` (the configuration's
    ``use_pallas_conv``), the bf16 conv kernel at each call whose shape and
    batch the JAX package's routing rule admits
    (``ops/conv3d.supports_shape``), as its ``Conv3x3x3`` decides.  With
    ``fused=True`` (identity skip only) the whole block is
    one call of the resblock kernels instead, as the JAX package's
    ``use_pallas_resblock`` path, where the kernels take the width
    (``ops/resblock.supports``; elsewhere the block runs unfused, as the JAX
    block leaves its kernel by shape); the parameters are the same either
    way.  Each GroupNorm+SiLU likewise runs ``F.group_norm`` + SiLU where
    the GN kernels refuse its width (``ops/groupnorm.supports``), and
    everywhere with ``gn_kernel=False`` (the configuration's
    ``use_pallas_gn: false``).
    ``dropout`` falls between the second GroupNorm+SiLU and the second conv,
    as in the reference: a masked multiply outside any kernel, the mask that
    of the forward's :class:`DropoutStream` from its element base.  The fused block computes the
    function without dropout, so it refuses an active one (the JAX block
    leaves its kernel then).
    ``use_scale_shift_norm``: ``emb_layers.1`` gives 2 x out_channels, a
    (scale, shift) pair, and the second GroupNorm is a plain one (a library
    call, as the JAX block's ``nn.GroupNorm``), then ``* (1 + scale) +
    shift`` and SiLU; the first keeps the GN kernel, and the block is never
    fused (the JAX block refuses its resblock kernel then)."""

    def __init__(self, channels: int, out_channels: int = None, emb_channels: int = None,
                 use_embed: bool = True, norm_groups: int = 32, fused: bool = False,
                 dropout: float = 0.0, conv_kernel: bool = False, gn_kernel: bool = True,
                 use_scale_shift_norm: bool = False):
        super().__init__()
        self.dropout = dropout
        self.scale_shift = use_scale_shift_norm and use_embed
        fused = fused and not self.scale_shift
        self.conv_kernel = conv_kernel
        self.gn_kernel = gn_kernel
        out_channels = out_channels or channels
        if fused and out_channels != channels:
            raise ValueError("the fused resblock takes only an identity skip")
        self.fused = fused
        self.in_groups = norm_groups if channels % norm_groups == 0 else channels
        self.out_groups = norm_groups if out_channels % norm_groups == 0 else out_channels
        self.in_layers = nn.Sequential(nn.GroupNorm(self.in_groups, channels, eps=1e-5), nn.SiLU(),
                                       nn.Conv3d(channels, out_channels, 3, padding=1))
        self.use_embed = use_embed
        if use_embed:
            self.emb_layers = nn.Sequential(
                nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels if self.scale_shift
                                     else out_channels))
        # index 2 stands for the reference's dropout, applied in forward; it
        # keeps the conv at out_layers.3, the name the weights carry
        self.out_layers = nn.Sequential(nn.GroupNorm(self.out_groups, out_channels, eps=1e-5),
                                        nn.SiLU(), nn.Identity(),
                                        nn.Conv3d(out_channels, out_channels, 3, padding=1))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = nn.Conv3d(channels, out_channels, 1)

    @staticmethod
    def _gn_silu(norm: nn.GroupNorm, x: torch.Tensor, emb=None,
                 kernel: bool = True) -> torch.Tensor:
        B, T, H, W, C = x.shape
        if not (kernel and gn_ops.supports(C, norm.num_groups)):
            # the library route: F.group_norm through a channel-first view, + SiLU
            h = x if emb is None else x + emb[:, None, None, None, :]
            h = F.group_norm(h.reshape(B, T * H * W, C).transpose(1, 2), norm.num_groups,
                             norm.weight, norm.bias, norm.eps)
            return F.silu(h).transpose(1, 2).reshape(x.shape)
        y = fused_groupnorm_silu(x.reshape(B, T * H * W, C).contiguous(), norm.weight, norm.bias,
                                 emb, norm.num_groups, norm.eps)
        return y.reshape(x.shape)

    @staticmethod
    def _scale_shift_silu(norm: nn.GroupNorm, h: torch.Tensor, emb_out: torch.Tensor):
        """silu(GroupNorm(h) * (1 + scale) + shift), (scale, shift) the two
        halves of ``emb_out``; the GroupNorm through a channel-first view."""
        B, T, H, W, C = h.shape
        n = F.group_norm(h.reshape(B, T * H * W, C).transpose(1, 2), norm.num_groups,
                         norm.weight, norm.bias, norm.eps).transpose(1, 2).reshape(h.shape)
        scale, shift = emb_out[:, None, None, None, :].chunk(2, dim=-1)
        return F.silu(n * (1 + scale) + shift)

    def _conv3(self, conv: nn.Conv3d, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        if self.conv_kernel and supports_shape(T, H, W, C, conv.out_channels, B):
            return fused_conv3x3x3(x.contiguous(), conv.weight, conv.bias)
        return conv_nthwc(conv, x)

    def _fused_forward(self, x: torch.Tensor, emb_out) -> torch.Tensor:
        if emb_out is None:
            emb_out = x.new_zeros((x.shape[0], x.shape[-1]))
        gn1, conv1 = self.in_layers[0], self.in_layers[2]
        gn2, conv2 = self.out_layers[0], self.out_layers[3]
        return fused_resblock(x.contiguous(), emb_out, conv1.weight, conv1.bias, conv2.weight,
                              conv2.bias, gn1.weight, gn1.bias, gn2.weight, gn2.bias,
                              gn1.num_groups, gn1.eps)

    def forward(self, x: torch.Tensor, emb: torch.Tensor = None,
                drop: Optional[DropoutStream] = None) -> torch.Tensor:
        emb_out = self.emb_layers(emb).contiguous() if self.use_embed else None
        active = is_active(self, drop, self.dropout)
        if self.fused and resblock_ops.supports(x.shape[-1], self.in_groups):
            if active:
                raise NotImplementedError("the fused resblock computes the block without "
                                          "dropout; build it with fused=False to train with one")
            return self._fused_forward(x, emb_out)
        h = self._gn_silu(self.in_layers[0], x, kernel=self.gn_kernel)
        h = self._conv3(self.in_layers[2], h)
        if self.scale_shift:
            h = self._scale_shift_silu(self.out_layers[0], h, emb_out)
        else:
            h = self._gn_silu(self.out_layers[0], h, emb_out, kernel=self.gn_kernel)
        if active:
            draw = (drop.seed, drop.next_site(), 0, h.shape, self.dropout, h.device)
            base, = drop.bases(h[0].numel())
            # base 0 (one process): the call as it always was
            mask = keep_mask(*draw, base=base) if base else keep_mask(*draw)
            h = apply_mask(h, mask, self.dropout)
        h = self._conv3(self.out_layers[3], h)
        skip = x if isinstance(self.skip_connection, nn.Identity) else conv_nthwc(self.skip_connection, x)
        return skip + h
