"""GroupNorm(+emb)+SiLU: ``silu(GroupNorm(x + emb[:, None]))`` on (B, N, C).

The kernel (``csrc/groupnorm.cu``) replaces
``prediff_tpu/ops/pallas_groupnorm.py::fused_groupnorm_silu``.  It is bound
by bytes: a stats pass and an apply pass, each one coalesced sweep over x,
with ``emb`` folded into both so that ``x + emb`` never reaches memory.
Statistics are Welford per channel merged by Chan's formula, never
E[x^2] - E[x]^2.  It takes any ``groups`` that divides C <= 1024, so the
UNet's 65-channel ``first_proj.in_layers_0`` (groups = 65) runs it too.

:func:`fused_groupnorm_silu` is differentiable.  Its backward has no kernel:
every gradient, dx included, is autograd of the plain version, as the JAX
package's ``_gn_diff_bwd`` differentiates its reference.
"""
from typing import Optional

import torch

from . import _build

_TOK_PER_SPLIT = 64    # tokens per stats block
_TOK_PER_BLOCK = 16    # tokens per apply block
_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {"gn_silu_forward": [_P] * 6 + [_I] * 6 + [_F, _P]}


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
        grads = _build.plain_grads(lambda *a: groupnorm_silu_plain(*a, *ctx.args),
                                   ctx.saved_tensors, ctx.needs_input_grad[:4], g)
        return (*grads, None, None)


def fused_groupnorm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         emb: Optional[torch.Tensor] = None, groups: int = 32,
                         eps: float = 1e-5) -> torch.Tensor:
    """CPU tensor: the plain version.  CUDA tensor: the kernel, or raise.
    Differentiable on both."""
    return _FusedGroupNormSiLU.apply(x, weight, bias, emb, groups, eps)


fused_groupnorm_silu.launches = 0
