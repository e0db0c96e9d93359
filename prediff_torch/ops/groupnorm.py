"""GroupNorm(+emb)+SiLU: ``silu(GroupNorm(x + emb[:, None]))`` on (B, N, C).

The kernel (``csrc/groupnorm.cu``) replaces
``prediff_tpu/ops/pallas_groupnorm.py::fused_groupnorm_silu``.  It is bound
by bytes, and reads x once: one launch of a thread-block cluster per
(sample, group), split along the tokens (:func:`gn_plan`), each block holding
its tokens x the group's channels in shared memory; statistics are Welford
per thread merged by Chan's formula (lanes, warps, then the cluster's ranks
in rank order through distributed shared memory), never E[x^2] - E[x]^2.
``emb`` is added where a value is read, so ``x + emb`` never reaches memory.
It takes any ``groups`` that divides C <= 1024, so the UNet's 65-channel
``first_proj.in_layers_0`` (groups = 65, one channel a group) runs it too.
The route is chosen by shape, never on failure: a (sample, group) that
does not fit the shared memory of a cluster of ``GN_MAX_CLUSTER`` blocks
(more than ~1.8 MB of values) takes the first design's two launches, a
stats pass and an apply pass, each one coalesced sweep over x.

:func:`fused_groupnorm_silu` is differentiable: its backward is one call of
:func:`fused_groupnorm_silu_bwd_full`, which replaces
``pallas_groupnorm.py::fused_groupnorm_silu_bwd_full`` and gives dx, dweight,
dbias and demb together, whichever of them was asked for.  It runs the
forward's design (``gn_silu_bwd_cluster``, ``csrc/gn_cluster.cuh``): one
launch of a cluster per (group, sample) (:func:`gn_bwd_plan`, the forward's
rule for a rank holding two f32 tiles, x and g; one-channel groups eight to
a cluster, so a token's row segment is 32 bytes), the values read once into
shared memory, the statistics merged in rank order, each thread on fixed
channels so dweight, dbias and demb are summed per channel over the block's
threads and then the ranks in order; a second launch adds the samples'
partials in order.  Where the plan gives none (a group past a cluster of 8
blocks' shared memory, or one a 256-thread block cannot hold on fixed
channels) the first design runs, by shape: one block per (group, sample)
making its passes over the group in device memory (``gn_silu_bwd_full``).
"""
import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from . import _build, weights

_TOK_PER_SPLIT = 64    # tokens per stats block (two-pass route)
_TOK_PER_BLOCK = 16    # tokens per apply block (two-pass route)
_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {name + form: args for name, args in (
    ("gn_silu_forward", [_P] * 6 + [_I] * 6 + [_F, _P]),
    ("gn_silu_cluster_forward", [_P] * 5 + [_I] * 7 + [_F, _P]),
    ("gn_silu_bwd_full", [_P] * 9 + [_I] * 5 + [_F, _P]),
    ("gn_silu_bwd_cluster", [_P] * 9 + [_I] * 7 + [_F, _P])) for form in ("", "_bf16")}
# csrc/groupnorm.cu gn_cluster_kernel: dynamic shared memory a block may take,
# threads a block, the largest (portable) cluster, and the blocks a launch
# aims for (about one per SM of the H100's 132)
GN_SMEM_CAP, GN_THREADS, GN_MAX_CLUSTER, GN_TARGET_BLOCKS = 232448 - 1024, 256, 8, 128
# csrc/gn_cluster.cuh kSmemCap (the backward kernel's dynamic shared memory cap)
# and kBundle (the one-channel groups one of its blocks takes together)
GN_BWD_SMEM_CAP, GN_BUNDLE = 232448 - 12288, 8


@dataclass(frozen=True)
class GnPlan:
    """The one-launch kernels' split: a cluster of ``cluster`` blocks per
    (sample, unit), a unit being ``bundle`` neighbouring groups (the
    backward's one-channel groups: 8; else 1), rank r holding tokens
    ``r * tpr .. r * tpr + tpr - 1`` (the last rank fewer) x the unit's
    ``width`` channels in shared memory (zeros past C), ``tiles`` f32 tiles
    of them (the forward x; the backward x and g), copied ``vw`` floats at a
    time (16 bytes where cpg allows)."""
    B: int
    N: int
    C: int
    groups: int
    cluster: int
    tiles: int = 1
    bundle: int = 1

    @property
    def cpg(self) -> int:
        return self.C // self.groups

    @property
    def width(self) -> int:
        return self.cpg * self.bundle

    @property
    def units(self) -> int:
        return -(-self.groups // self.bundle)

    @property
    def tpr(self) -> int:
        return -(-self.N // self.cluster)

    @property
    def vw(self) -> int:
        return 4 if self.cpg % 4 == 0 else 1

    @property
    def blocks(self) -> int:
        return self.B * self.units * self.cluster

    @property
    def smem_bytes(self) -> int:
        """The rank's tiles and three channel vectors (the forward: the
        group's emb, gamma and beta; the backward: the rank's dgamma, dbeta
        and demb sums)."""
        return 4 * (self.tiles * self.tpr * self.width + 3 * self.width)

    @property
    def smem_cap(self) -> int:
        """The dynamic shared memory the kernel may take."""
        return GN_SMEM_CAP if self.tiles == 1 else GN_BWD_SMEM_CAP

    def tile(self, b: int, unit: int, rank: int):
        """(sample, tokens, channels) that block ``rank`` of the cluster of
        (b, unit) holds and writes."""
        n0 = rank * self.tpr
        return (b, range(min(n0, self.N), min(n0 + self.tpr, self.N)),
                range(unit * self.width, min((unit + 1) * self.width, self.C)))


@lru_cache(maxsize=None)
def gn_plan(B: int, N: int, C: int, groups: int, tiles: int = 1,
            bundle: int = 1) -> Optional[GnPlan]:
    """The one-launch kernel's plan for x (B, N, C), or None where a
    (sample, group) does not fit even a cluster of ``GN_MAX_CLUSTER`` blocks:
    that shape takes the two-pass kernels.  The cluster is the smallest of
    1, 2, 4, 8 (at most N) that gives ``GN_TARGET_BLOCKS`` blocks, or larger
    until a rank's ``tiles`` tiles fit the kernel's shared memory."""
    sizes = [c for c in (1, 2, 4, GN_MAX_CLUSTER) if c <= max(N, 1)]
    units = -(-groups // bundle)
    want = next((c for c in sizes if B * units * c >= GN_TARGET_BLOCKS), sizes[-1])
    for c in sizes:
        plan = GnPlan(B, N, C, groups, c, tiles, bundle)
        if c >= want and plan.smem_bytes <= plan.smem_cap:
            return plan
    return None


def gn_bwd_plan(B: int, N: int, C: int, groups: int) -> Optional[GnPlan]:
    """The cluster backward's plan (``csrc/gn_cluster.cuh``; the all-gradients
    backward and the resblock's GN passes): the forward's rule for two tiles
    a rank, x (+ emb) and the cotangent, one-channel groups in bundles of
    ``GN_BUNDLE``; or None where a (sample, group) does not fit a cluster of
    8 or a 256-thread block cannot keep each thread on fixed channels
    (``GN_THREADS * vw % width``): the one-block-per-group kernels.  By shape
    alone."""
    if groups < 1 or C % groups:
        return None
    plan = gn_plan(B, N, C, groups, tiles=2, bundle=GN_BUNDLE if C == groups else 1)
    if plan is None or (GN_THREADS * plan.vw) % plan.width:
        return None
    return plan


@_build.widened
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


@_build.widened
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


def supports(C: int, groups: int) -> bool:
    """True exactly where both GN kernels (the forward and the all-gradients
    backward) launch on a CUDA tensor of C channels in ``groups`` groups
    instead of raising: groups divides C, C <= 1024 (the forward), and a
    backward block (a multiple of 32 threads and of the group's channels)
    stays within 1024 threads.  The
    blocks that call GN route by it; the route depends on the shape alone."""
    return (groups >= 1 and C % groups == 0 and C <= 1024
            and math.lcm(C // groups, 32) <= 1024)


def fused_groupnorm_silu_bwd_full(x: torch.Tensor, g: torch.Tensor, weight: torch.Tensor,
                                  bias: torch.Tensor, emb: Optional[torch.Tensor] = None,
                                  groups: int = 32, eps: float = 1e-5):
    """(dx, dweight, dbias, demb or None).  CPU tensor: the plain version.
    CUDA tensor: the kernels (any ``groups`` that divides C, as the forward;
    the route by :func:`gn_bwd_plan`), or raise.  x, g, emb and dx f32, or
    bf16 (the bf16 forms); dweight, dbias and demb f32."""
    if not _build.on_card(fused_groupnorm_silu_bwd_full, x):
        return groupnorm_silu_bwd_full_plain(x, g, weight, bias, emb, groups, eps)
    B, N, C = x.shape
    if C % groups != 0 or math.lcm(C // groups, 32) > 1024:
        raise ValueError(f"groupnorm_bwd_full kernel: C={C}, groups={groups} not supported")
    form, dt = _build.io_form("groupnorm_bwd_full", x), x.dtype
    weight, bias = weights.f32(weight), weights.f32(bias)
    _build.require("groupnorm_bwd_full", [("x", x, (B, N, C), dt), ("g", g, (B, N, C), dt),
                                          ("weight", weight, (C,)), ("bias", bias, (C,))]
                   + ([("emb", emb, (B, C), dt)] if emb is not None else []))
    plan = gn_bwd_plan(B, N, C, groups)
    if plan is not None and plan.vw == 4:   # 16-byte copies
        x, g = _build.aligned16(x, g)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    demb = torch.empty((B, C), **f32) if emb is not None else None
    gpart, vec = torch.empty((B, 2, C), **f32), torch.empty((2, C), **f32)
    lib = _build.load("groupnorm", _SIGNATURES)
    head = (_build.ptr(x), _build.ptr(emb) if emb is not None else None, _build.ptr(g),
            _build.ptr(weight), _build.ptr(bias), _build.ptr(dx),
            _build.ptr(demb) if demb is not None else None, _build.ptr(gpart), _build.ptr(vec),
            B, N, C, groups)
    if plan is not None:
        err = getattr(lib, "gn_silu_bwd_cluster" + form)(
            *head, plan.cluster, plan.tpr, plan.vw, float(eps), _build.stream_ptr(x.device))
        _build.check(err, "gn_silu_bwd_cluster" + form)
    else:
        # a block of a (group, sample): a multiple of 32 threads and of the
        # group's channels, so that each thread stays on one channel
        unit = math.lcm(C // groups, 32)
        threads = max(256 // unit, 1) * unit
        err = getattr(lib, "gn_silu_bwd_full" + form)(*head, threads, float(eps),
                                                      _build.stream_ptr(x.device))
        _build.check(err, "gn_silu_bwd_full" + form)
    _build.count(fused_groupnorm_silu_bwd_full, form)
    return dx, vec[0], vec[1], demb


def _groupnorm_kernel(x, weight, bias, emb, groups, eps):
    B, N, C = x.shape
    if C % groups != 0 or C > 1024:
        raise ValueError(f"groupnorm kernel: C={C}, groups={groups} not supported")
    form, dt = _build.io_form("groupnorm", x), x.dtype
    weight, bias = weights.f32(weight), weights.f32(bias)
    _build.require("groupnorm", [("x", x, (B, N, C), dt), ("weight", weight, (C,)),
                                 ("bias", bias, (C,))]
                   + ([("emb", emb, (B, C), dt)] if emb is not None else []))
    plan = gn_plan(B, N, C, groups)
    if plan is not None and plan.vw == 4:   # 16-byte copies
        (x,) = _build.aligned16(x)
    y = torch.empty_like(x)
    lib = _build.load("groupnorm", _SIGNATURES)
    head = (_build.ptr(x), _build.ptr(emb) if emb is not None else None, _build.ptr(weight),
            _build.ptr(bias), _build.ptr(y))
    if plan is not None:
        err = getattr(lib, "gn_silu_cluster_forward" + form)(
            *head, B, N, C, groups, plan.cluster, plan.tpr, plan.vw, float(eps),
            _build.stream_ptr(x.device))
        _build.check(err, "gn_silu_cluster_forward" + form)
    else:
        part = torch.empty((B, -(-N // _TOK_PER_SPLIT), groups, 3), dtype=torch.float32,
                           device=x.device)
        err = getattr(lib, "gn_silu_forward" + form)(
            *head, _build.ptr(part), B, N, C, groups, _TOK_PER_SPLIT, _TOK_PER_BLOCK, float(eps),
            _build.stream_ptr(x.device))
        _build.check(err, "gn_silu_forward" + form)
    _build.count(fused_groupnorm_silu, form)
    return y


def _groupnorm_forward(x, weight, bias, emb, groups, eps):
    if not _build.on_card(fused_groupnorm_silu, x):
        return groupnorm_silu_plain(x, weight, bias, emb, groups, eps)
    return _groupnorm_kernel(x, weight, bias, emb, groups, eps)


class _FusedGroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, emb, groups, eps):
        ctx.save_for_backward(x, weight, bias, emb)
        ctx.args = (groups, eps)
        return _groupnorm_forward(x, weight, bias, emb, groups, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, emb = ctx.saved_tensors
        grads = fused_groupnorm_silu_bwd_full(x, g.contiguous(), weight, bias, emb, *ctx.args)
        return (*(gr if n else None for gr, n in zip(grads, ctx.needs_input_grad)), None, None)


def fused_groupnorm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         emb: Optional[torch.Tensor] = None, groups: int = 32,
                         eps: float = 1e-5) -> torch.Tensor:
    """CPU tensor: the plain version.  CUDA tensor: the kernel, or raise.
    Differentiable on both; where autograd records nothing the call goes
    straight to the forward, without the ``autograd.Function``."""
    if _build.needs_grad(x, weight, bias, emb):
        return _FusedGroupNormSiLU.apply(x, weight, bias, emb, groups, eps)
    return _groupnorm_forward(x, weight, bias, emb, groups, eps)


fused_groupnorm_silu.launches = fused_groupnorm_silu.bf16_launches = 0
fused_groupnorm_silu_bwd_full.launches = fused_groupnorm_silu_bwd_full.bf16_launches = 0
