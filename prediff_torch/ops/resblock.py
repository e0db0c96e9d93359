"""Whole TimeEmbedResBlock (identity skip, non-scale-shift) on (B, T, H, W, C):

    out = x + conv2(silu(GN2(conv1(silu(GN1 x)) + b1 + emb))) + b2

The kernels (``csrc/resblock.cu``) replace
``prediff_tpu/ops/pallas_resblock.py::fused_resblock`` and its backward
``_fused_resblock_bwd``: the four convolutions run on the standalone conv's
TMA + wgmma kernel (``csrc/conv_wgmma.cuh``; bf16 operands, f32
accumulation, tiled by ``ops/conv3d.conv_tiles``), each GroupNorm pass in
one launch of a thread-block cluster per (group, sample) (row 1's design,
:func:`gn_tiles`; the backward passes on ``csrc/gn_cluster.cuh``, the
kernel of GN+SiLU's all-gradients backward).  The forward also returns ``h2 = conv1(.) + b1``, kept
for the backward (bf16 from the kernel, as the TPU kernel keeps it); the
backward gives (dx, demb).  Conv weights are in PyTorch ``Conv3d`` layout
(C, C, 3, 3, 3); the kernels read their bf16 layouts, the forward's and the
flipped transpose of the backward, laid out once per parameter version by
``ops/conv3d.weight_map`` (the cache of ``ops/weights.py``).

:func:`fused_resblock` is differentiable: (dx, demb) from
:func:`fused_resblock_bwd`, parameter gradients (only when asked for) from
autograd of the f32 plain version.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, conv3d, weights
from .ffn import _round
from .groupnorm import gn_bwd_plan, groupnorm_silu_plain

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {name + form: args for name, args in (
    ("resblock_forward", [_P] * 13 + [_I] * 13 + [_F, _P]),
    ("resblock_backward", [_P] * 15 + [_I] * 13 + [_F, _P])) for form in ("", "_bf16")}
_GN_THREADS = 256   # csrc/resblock.cu kGnThreads


def supports(C: int, groups: int) -> bool:
    """What the kernels take: C a multiple of 64 (the conv's 64-channel
    input slice and smallest output tile; the alignment net's 128 and 256
    fit), groups dividing C with
    C / groups dividing 256 (the GN block's threads)."""
    return C % 64 == 0 and C % groups == 0 and _GN_THREADS % (C // groups) == 0


def _conv(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return F.conv3d(v.permute(0, 4, 1, 2, 3), k, padding=1).permute(0, 2, 3, 4, 1)


def _conv_t(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Input gradient of ``_conv(., k)``."""
    return F.conv_transpose3d(v.permute(0, 4, 1, 2, 3), k, padding=1).permute(0, 2, 3, 4, 1)


def _silu_grad(a: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(a)
    return s * (1.0 + a * (1.0 - s))


def _gn_silu(v: torch.Tensor, scale, shift, groups: int, eps: float, emb=None) -> torch.Tensor:
    """silu(GroupNorm(v + emb)) on (B, T, H, W, C)."""
    B, C = v.shape[0], v.shape[-1]
    return groupnorm_silu_plain(v.reshape(B, -1, C), scale, shift, emb, groups,
                                eps).reshape(v.shape)


@_build.widened
def resblock_plain(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups: int = 32,
                   eps: float = 1e-5, mxu_dtype: Optional[torch.dtype] = None):
    """Plain PyTorch version: (out, h2).  ``mxu_dtype`` rounds h1, h2, h3 and
    the conv weights where the kernel does; ``None`` keeps f32."""
    xf = x.float()
    h = _round(_gn_silu(xf, g1s, g1b, groups, eps), mxu_dtype)
    h2 = _round(_conv(h, _round(k1, mxu_dtype)) + b1, mxu_dtype)
    h = _round(_gn_silu(h2, g2s, g2b, groups, eps, emb.float()), mxu_dtype)
    out = xf + (_conv(h, _round(k2, mxu_dtype)) + b2)
    return out.to(x.dtype), h2


def _gn_silu_bwd(v, dy, scale, shift, groups, eps):
    """Input gradient of silu(GroupNorm(v)) for dy, the TPU kernel's formula:
    ``rstd (u - (sum u + xhat sum(u xhat)) / count)``, u = dy silu'(a) scale,
    the sums over each (sample, group)."""
    B, C = v.shape[0], v.shape[-1]
    g = v.reshape(B, -1, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt((g - mean).square().mean(dim=(1, 3), keepdim=True) + eps)
    xhat = ((g - mean) * rstd).reshape(v.shape)
    u = dy * _silu_grad(xhat * scale + shift) * scale
    ug, xg = u.reshape(g.shape), xhat.reshape(g.shape)
    s1 = ug.sum(dim=(1, 3), keepdim=True)
    s2 = (ug * xg).sum(dim=(1, 3), keepdim=True)
    count = g.shape[1] * g.shape[3]
    return (rstd * (ug - (s1 + xg * s2) / count)).reshape(v.shape)


@_build.widened
def resblock_bwd_plain(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g, groups: int = 32,
                       eps: float = 1e-5, mxu_dtype: Optional[torch.dtype] = None):
    """Plain (dx, demb) of :func:`resblock_plain` for the cotangent ``g``,
    given the forward's ``h2``; ``mxu_dtype`` rounds g, dh3, dv, dh1 and the
    weights where the kernel does."""
    xf, gf = x.float(), g.float()
    v = h2.float() + emb.float()[:, None, None, None, :]
    dh3 = _round(_conv_t(_round(gf, mxu_dtype), _round(k2, mxu_dtype)), mxu_dtype)
    dv = _gn_silu_bwd(v, dh3, g2s, g2b, groups, eps)
    demb = dv.sum(dim=(1, 2, 3))
    dh1 = _round(_conv_t(_round(dv, mxu_dtype), _round(k1, mxu_dtype)), mxu_dtype)
    dx = _gn_silu_bwd(xf, dh1, g1s, g1b, groups, eps) + gf
    return dx.to(x.dtype), demb.to(emb.dtype)


def _specs(x, emb, groups, **vectors):
    """The checks of x and emb (f32, or bf16: the bf16 forms) and of the
    parameter vectors (f32)."""
    B, T, H, W, C = x.shape
    if not supports(C, groups):
        raise ValueError(f"resblock kernel: C={C}, groups={groups} not supported "
                         f"(C % 64 == 0, 256 % (C / groups) == 0)")
    return ([("x", x, (B, T, H, W, C), x.dtype), ("emb", emb, (B, C), x.dtype)]
            + [(n, t, (C,)) for n, t in vectors.items()])


def gn_tiles(B: int, N: int, C: int, groups: int):
    """(ranks, tokens a rank) of the GroupNorm passes' clusters, forward and
    backward: ``ops/groupnorm.gn_bwd_plan`` (row 1's rule for the backward's
    two f32 tiles a rank, the values and dh); (0, 0) where it gives none: the
    one-block-per-group kernels."""
    plan = gn_bwd_plan(B, N, C, groups)
    return (0, 0) if plan is None else (plan.cluster, plan.tpr)


def _conv_args(x, k1, k2, groups: int, dx: bool):
    """The two convs' weight maps (the forward's layouts, or with ``dx`` the
    flipped transposes) and the tiles: the convs' output-channel tile, box
    (bt, bh, bw) and cluster split (``conv_tiles``), then the GroupNorm
    passes' ranks and tokens a rank."""
    B, T, H, W, C = x.shape
    _build.require("resblock", [("k1", k1, (C, C, 3, 3, 3), k1.dtype),
                                ("k2", k2, (C, C, 3, 3, 3), k2.dtype)])
    plan = conv3d.conv_tiles(B, T, H, W, C, C)
    return ([conv3d.weight_map(k1, dx, plan.n_tile)[1], conv3d.weight_map(k2, dx, plan.n_tile)[1]],
            [plan.n_tile, *plan.box, plan.splits, *gn_tiles(B, T * H * W, C, groups)])


def fused_resblock_fwd(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups: int = 32,
                       eps: float = 1e-5):
    """(out, h2).  CPU tensor: the plain version in f32.  CUDA tensor: the
    kernels, or raise.  x, emb and out f32, or bf16 (the bf16 forms); h2 bf16."""
    if not _build.on_card(fused_resblock_fwd, x):
        return resblock_plain(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups, eps)
    B, T, H, W, C = x.shape
    form = _build.io_form("resblock", x)
    b1, b2, g1s, g1b, g2s, g2b = (weights.f32(t) for t in (b1, b2, g1s, g1b, g2s, g2b))
    _build.require("resblock", _specs(x, emb, groups, b1=b1, b2=b2, g1s=g1s, g1b=g1b,
                                      g2s=g2s, g2b=g2b))
    (w1, w2), tiles = _conv_args(x, k1, k2, groups, dx=False)
    h = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    h2 = torch.empty_like(h)
    out = torch.empty_like(x)
    lib = _build.load("resblock", _SIGNATURES)
    p = _build.ptr
    err = getattr(lib, "resblock_forward" + form)(
        p(x), p(emb), w1, p(b1), w2, p(b2), p(g1s), p(g1b), p(g2s), p(g2b), p(h), p(h2), p(out),
        B, T, H, W, C, groups, *tiles, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "resblock_forward" + form)
    _build.count(fused_resblock_fwd, form)
    return out, h2


def fused_resblock_bwd(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g, groups: int = 32,
                       eps: float = 1e-5):
    """(dx, demb) for the cotangent ``g``.  CPU tensor: the plain version in
    f32.  CUDA tensor: the kernels, or raise.  x, emb, g and dx f32, or bf16
    (the bf16 forms: g is the first conv's operand as it is); demb f32."""
    if not _build.on_card(fused_resblock_bwd, x):
        return resblock_bwd_plain(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g, groups, eps)
    B, T, H, W, C = x.shape
    form = _build.io_form("resblock_bwd", x)
    g1s, g1b, g2s, g2b = (weights.f32(t) for t in (g1s, g1b, g2s, g2b))
    _build.require("resblock_bwd", _specs(x, emb, groups, g1s=g1s, g1b=g1b, g2s=g2s, g2b=g2b)
                   + [("g", g, x.shape, x.dtype), ("h2", h2, x.shape, torch.bfloat16)])
    (w1t, w2t), tiles = _conv_args(x, k1, k2, groups, dx=True)
    x, g = _build.aligned16(x, g)   # the GN passes' 16-byte copies and the g cast
    # the f32 cotangent's bf16 copy (the bf16 form reads g as it is)
    gb = torch.empty(x.shape if not form else (0,), dtype=torch.bfloat16, device=x.device)
    dh, dv = (torch.empty(x.shape, dtype=torch.bfloat16, device=x.device) for _ in range(2))
    dx = torch.empty_like(x)
    demb = torch.empty((B, C), dtype=torch.float32, device=x.device)
    lib = _build.load("resblock", _SIGNATURES)
    p = _build.ptr
    err = getattr(lib, "resblock_backward" + form)(
        p(x), p(emb), p(g), p(h2), w1t, w2t, p(g1s), p(g1b), p(g2s), p(g2b), p(gb), p(dh), p(dv),
        p(dx), p(demb), B, T, H, W, C, groups, *tiles, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "resblock_backward" + form)
    _build.count(fused_resblock_bwd, form)
    return dx, demb


class _FusedResBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups, eps):
        out, h2 = fused_resblock_fwd(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups, eps)
        ctx.save_for_backward(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, h2)
        ctx.args = (groups, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, h2 = ctx.saved_tensors
        groups, eps = ctx.args
        dx = demb = None
        if any(ctx.needs_input_grad[:2]):
            dx, demb = fused_resblock_bwd(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2,
                                          g.contiguous(), groups, eps)
        dparams = _build.plain_grads(
            lambda *p: resblock_plain(x, emb, *p, groups, eps)[0],
            (k1, b1, k2, b2, g1s, g1b, g2s, g2b), ctx.needs_input_grad[2:10], g)
        return (dx, demb, *dparams, None, None)


def fused_resblock(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups: int = 32,
                   eps: float = 1e-5) -> torch.Tensor:
    """The block's output; differentiable.  CPU tensor: the plain version in
    f32.  CUDA tensor: the kernels, or raise."""
    return _FusedResBlock.apply(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups, eps)


fused_resblock_fwd.launches = fused_resblock_fwd.bf16_launches = 0
fused_resblock_bwd.launches = fused_resblock_bwd.bf16_launches = 0
