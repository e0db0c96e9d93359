"""GroupNorm(+emb)+SiLU: ``silu(GroupNorm(x + emb[:, None]))`` on (B, N, C).

The kernel (``csrc/groupnorm.cu``) replaces
``prediff_tpu/ops/pallas_groupnorm.py::fused_groupnorm_silu``.  It is bound
by bytes: a stats pass and an apply pass, each one coalesced sweep over x,
with ``emb`` folded into both so that ``x + emb`` never reaches memory.
Statistics are Welford per channel merged by Chan's formula, never
E[x^2] - E[x]^2.  It takes any ``groups`` that divides C <= 1024, so the
UNet's 65-channel ``first_proj.in_layers_0`` (groups = 65) runs it too.

:func:`fused_groupnorm_silu` is differentiable: its backward is one call of
:func:`fused_groupnorm_silu_bwd_full` (``gn_silu_bwd_full`` in the same
source), which replaces
``pallas_groupnorm.py::fused_groupnorm_silu_bwd_full`` and gives dx, dweight,
dbias and demb together, whichever of them was asked for.
"""
import math
from typing import Optional

import torch

from . import _build

_TOK_PER_SPLIT = 64    # tokens per stats block
_TOK_PER_BLOCK = 16    # tokens per apply block
_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {"gn_silu_forward": [_P] * 6 + [_I] * 6 + [_F, _P],
               "gn_silu_bwd_full": [_P] * 9 + [_I] * 5 + [_F, _P]}


def groupnorm_silu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         emb: Optional[torch.Tensor] = None, groups: int = 32,
                         eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version (torch GroupNorm semantics, f32)."""
    B, N, C = x.shape
    xf = x.float()
    if emb is not None:
        xf = xf + emb.float()[:, None]
    g = xf.reshape(B, N, groups, C // groups)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = (g - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + eps)).reshape(B, N, C) * weight + bias
    return (y * torch.sigmoid(y)).to(x.dtype)


def groupnorm_silu_bwd_full_plain(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, emb: Optional[torch.Tensor] = None,
                                  groups: int = 32, eps: float = 1e-5):
    """Plain (dx, dweight, dbias, demb or None) of :func:`groupnorm_silu_plain`
    for the cotangent ``g``, the TPU kernel's formulas, all f32: the group
    statistics recomputed from x (+ emb), demb the sum of dx over the tokens."""
    B, N, C = x.shape
    xf = x.float()
    if emb is not None:
        xf = xf + emb.float()[:, None]
    xg = xf.reshape(B, N, groups, C // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    nhat = ((xg - mean) * torch.rsqrt(var + eps)).reshape(B, N, C)
    a = nhat * weight + bias
    sig = torch.sigmoid(a)
    dy = g.float() * sig * (1.0 + a * (1.0 - sig))
    u = (dy * weight).reshape(B, N, groups, C // groups)
    nh = nhat.reshape(B, N, groups, C // groups)
    dx = (torch.rsqrt(var + eps) * (u - u.mean(dim=(1, 3), keepdim=True)
                                    - nh * (u * nh).mean(dim=(1, 3), keepdim=True)))
    dx = dx.reshape(B, N, C)
    return (dx.to(x.dtype), (dy * nhat).sum(dim=(0, 1)), dy.sum(dim=(0, 1)),
            dx.sum(dim=1) if emb is not None else None)


def fused_groupnorm_silu_bwd_full(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, emb: Optional[torch.Tensor] = None,
                                  groups: int = 32, eps: float = 1e-5):
    """(dx, dweight, dbias, demb or None).  CPU tensor: the plain version.
    CUDA tensor: the kernel (any ``groups`` that divides C, as the forward),
    or raise."""
    if not x.is_cuda:
        return groupnorm_silu_bwd_full_plain(x, g, weight, bias, emb, groups, eps)
    B, N, C = x.shape
    if C % groups != 0:
        raise ValueError(f"groupnorm kernel: C={C}, groups={groups} not supported")
    # a block of a (group, sample): a multiple of 32 threads and of the
    # group's channels, so that each thread stays on one channel
    unit = math.lcm(C // groups, 32)
    if unit > 1024:
        raise ValueError(f"groupnorm_bwd_full kernel: {C // groups} channels per group "
                         "not supported")
    threads = max(256 // unit, 1) * unit
    _build.require("groupnorm_bwd_full", [("x", x, (B, N, C)), ("g", g, (B, N, C)),
                                          ("weight", weight, (C,)), ("bias", bias, (C,))]
                   + ([("emb", emb, (B, C))] if emb is not None else []))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    demb = torch.empty((B, C), **f32) if emb is not None else None
    gpart, vec = torch.empty((B, 2, C), **f32), torch.empty((2, C), **f32)
    lib = _build.load("groupnorm", _SIGNATURES)
    err = lib.gn_silu_bwd_full(
        _build.ptr(x), _build.ptr(emb) if emb is not None else None, _build.ptr(g),
        _build.ptr(weight), _build.ptr(bias), _build.ptr(dx),
        _build.ptr(demb) if demb is not None else None, _build.ptr(gpart), _build.ptr(vec),
        B, N, C, groups, threads, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "gn_silu_bwd_full")
    fused_groupnorm_silu_bwd_full.launches += 1
    return dx, vec[0], vec[1], demb


def _groupnorm_kernel(x, weight, bias, emb, groups, eps):
    B, N, C = x.shape
    if C % groups != 0 or C > 1024:
        raise ValueError(f"groupnorm kernel: C={C}, groups={groups} not supported")
    _build.require("groupnorm", [("x", x, (B, N, C)), ("weight", weight, (C,)),
                                 ("bias", bias, (C,))]
                   + ([("emb", emb, (B, C))] if emb is not None else []))
    nsplit = -(-N // _TOK_PER_SPLIT)
    part = torch.empty((B, nsplit, groups, 3), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    lib = _build.load("groupnorm", _SIGNATURES)
    err = lib.gn_silu_forward(
        _build.ptr(x), _build.ptr(emb) if emb is not None else None,
        _build.ptr(weight), _build.ptr(bias), _build.ptr(y), _build.ptr(part),
        B, N, C, groups, _TOK_PER_SPLIT, _TOK_PER_BLOCK, float(eps),
        _build.stream_ptr(x.device))
    _build.check(err, "gn_silu_forward")
    fused_groupnorm_silu.launches += 1
    return y


class _FusedGroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, emb, groups, eps):
        ctx.save_for_backward(x, weight, bias, emb)
        ctx.args = (groups, eps)
        if not x.is_cuda:
            return groupnorm_silu_plain(x, weight, bias, emb, groups, eps)
        return _groupnorm_kernel(x, weight, bias, emb, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, emb = ctx.saved_tensors
        grads = fused_groupnorm_silu_bwd_full(x, g.contiguous(), weight, bias, emb, *ctx.args)
        return (*(gr if n else None for gr, n in zip(grads, ctx.needs_input_grad)), None, None)


def fused_groupnorm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         emb: Optional[torch.Tensor] = None, groups: int = 32,
                         eps: float = 1e-5) -> torch.Tensor:
    """CPU tensor: the plain version.  CUDA tensor: the kernel, or raise.
    Differentiable on both."""
    return _FusedGroupNormSiLU.apply(x, weight, bias, emb, groups, eps)


fused_groupnorm_silu.launches = 0
fused_groupnorm_silu_bwd_full.launches = 0
