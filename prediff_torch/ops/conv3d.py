"""The UNet's 3x3x3 stride-1 SAME convolution + bias with bf16 operands, on
channel-last (B, T, H, W, C) f32, weights in PyTorch ``Conv3d`` layout
(OC, C, 3, 3, 3):

    out = conv(bf16(x), bf16(w)) + b        (f32 accumulation, f32 out)

The kernel (``csrc/conv3d.cu``, the implicit GEMM of ``csrc/conv3.cuh``)
replaces ``prediff_tpu/ops/pallas_conv3d.py::fused_conv3x3x3``, the opt-in
route of the JAX package's ``Conv3x3x3`` (``use_pallas_conv=True``).
:func:`fused_conv3x3x3` is differentiable as the JAX package's
``fused_conv3x3x3_diff`` is: dx is the same kernel on the cotangent with the
flipped, channel-transposed weights where :func:`supports_shape` admits the
cotangent's shape, else the f32 transposed conv; dw is the f32 weight
gradient from the unrounded x; db the f32 sum of the cotangent.
"""
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .ffn import _round

_P, _I = _build.P, _build.I
_SIGNATURES = {"conv3x3x3_forward": [_P] * 5 + [_I] * 7 + [_P]}
# the JAX package's VMEM budget of its routing rule (prediff_tpu/ops/dispatch.py)
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
TAP_SPLITS = (1, 3, 9)   # how the conv may split its 27 taps (each divides 27)
_TOKEN_TILE, _CHANNEL_TILE = 32, 64   # csrc/conv3.cuh kCM, kCN


def _plan(T: int, H: int, W: int, C: int, OC: int, bytes_per_el: int = 2):
    """The JAX kernel's tiling: (row_tile, n_rows, oc_tile, Rpad, L) or None."""
    if C % 128 or OC % 128:
        return None
    Tp, Hp, Wp = T + 2, H + 2, W + 2
    R = Tp * Hp * Wp
    off_max = 2 * Hp * Wp + 2 * Wp + 2
    L = R - off_max

    def ceil16(v):
        return -(-v // 16) * 16

    rt_cap = (4_500_000 // (27 * C * bytes_per_el)) // 16 * 16
    if rt_cap < 16:
        return None
    n_rows = -(-L // rt_cap)
    rt = min(rt_cap, ceil16(-(-L // n_rows)))
    while n_rows * rt < L:
        n_rows += 1
        rt = min(rt_cap, ceil16(-(-L // n_rows)))
    oc_tile = OC
    while oc_tile > 128 and 27 * C * oc_tile * bytes_per_el > 6 * 1024 * 1024:
        oc_tile //= 2
    if OC % oc_tile:
        return None
    off_pad = -(-off_max // 8) * 8
    Rpad = n_rows * rt + off_pad
    return rt, n_rows, oc_tile, Rpad, L


def supports_shape(T: int, H: int, W: int, C: int, OC: int, B: int = 1) -> bool:
    """Whether a conv of (B, T, H, W, C) -> OC takes the bf16 route: the JAX
    package's routing rule (``pallas_conv3d.supports_shape``, arithmetic
    copied), kept so that both packages send the same sites, at each batch
    size, to the bf16 route.  It is the TPU kernel's VMEM budget, not a limit
    of the CUDA kernel, which takes any C and OC that are multiples of 64."""
    plan = _plan(T, H, W, C, OC)
    if plan is None:
        return False
    rt, n_rows, oc_tile, Rpad, L = plan
    off_pad = Rpad - n_rows * rt
    xp_bufs = 2 if B > 1 else 1
    bytes_ = (xp_bufs * Rpad * C * 2 + 27 * C * oc_tile * 2 + rt * 27 * C * 2
              + (rt + off_pad) * C * 2 + rt * oc_tile * (4 + 2 * 4))
    return bytes_ <= VMEM_BUDGET_BYTES


def _ncthw(v: torch.Tensor) -> torch.Tensor:
    return v.permute(0, 4, 1, 2, 3)


def _nthwc(v: torch.Tensor) -> torch.Tensor:
    return v.permute(0, 2, 3, 4, 1)


def conv3x3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    mxu_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """Plain version: x and the weights rounded to ``mxu_dtype`` (``None``
    keeps f32), an f32 conv, the bias in f32; out in x's dtype."""
    out = _nthwc(F.conv3d(_ncthw(_round(x.float(), mxu_dtype)),
                          _round(weight.float(), mxu_dtype), padding=1))
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def conv3x3x3_dx_plain(g: torch.Tensor, weight: torch.Tensor,
                       mxu_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """Plain input gradient of :func:`conv3x3x3_plain` for the cotangent ``g``
    (B, T, H, W, OC): the transposed conv of the rounded g and weights, which
    is the SAME conv with flipped taps and in / out channels swapped."""
    return _nthwc(F.conv_transpose3d(_ncthw(_round(g.float(), mxu_dtype)),
                                     _round(weight.float(), mxu_dtype), padding=1)).to(g.dtype)


def conv_weight(k: torch.Tensor) -> torch.Tensor:
    """Conv3d weight (out, in, 3, 3, 3) -> the kernel's (27, in, out)."""
    return k.permute(2, 3, 4, 1, 0).reshape(27, k.shape[1], k.shape[0]).contiguous()


def conv_weight_t(k: torch.Tensor) -> torch.Tensor:
    """The transposed conv's weight for the kernel: flipped taps, (27, out, in)."""
    return k.flip(2, 3, 4).permute(2, 3, 4, 0, 1).reshape(27, k.shape[0],
                                                          k.shape[1]).contiguous()


def tap_splits(tokens: int, out_channels: int) -> int:
    """The fewest tap splits that give about ``_build.TARGET_BLOCKS`` blocks
    from the conv's (32-token, 64-channel) tiles."""
    tiles = -(-tokens // _TOKEN_TILE) * (out_channels // _CHANNEL_TILE)
    return next((s for s in TAP_SPLITS if tiles * s >= _build.TARGET_BLOCKS), TAP_SPLITS[-1])


def _launch(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on x (B, T, H, W, K) and w (27, K, N) laid out for it."""
    B, T, H, W, K = x.shape
    N = w.shape[-1]
    if K % 32 or N % 64:
        raise ValueError(f"conv3x3x3 kernel: {K} -> {N} channels not supported (K % 32 == 0, "
                         "N % 64 == 0)")
    specs = [("x", x, (B, T, H, W, K)), ("w", w, (27, K, N))]
    if bias is not None:
        specs.append(("bias", bias, (N,)))
    _build.require("conv3x3x3", specs)
    if x.data_ptr() % 16:
        raise ValueError("conv3x3x3 kernel: x must be 16-byte aligned")
    splits = tap_splits(B * T * H * W, N)
    part = torch.empty((splits, B * T * H * W, N), dtype=torch.float32, device=x.device)
    out = torch.empty((B, T, H, W, N), dtype=torch.float32, device=x.device)
    lib = _build.load("conv3d", _SIGNATURES)
    err = lib.conv3x3x3_forward(_build.ptr(x), _build.ptr(w),
                                None if bias is None else _build.ptr(bias), _build.ptr(part),
                                _build.ptr(out), B, T, H, W, K, N, splits,
                                _build.stream_ptr(x.device))
    _build.check(err, "conv3x3x3_forward")
    return out


def conv3x3x3_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The conv's forward.  CPU tensor: the plain version (the same bf16
    rounding).  CUDA tensor: the kernel, or raise."""
    if not x.is_cuda:
        return conv3x3x3_plain(x, weight, bias)
    out = _launch(x, conv_weight(weight.float()), bias)
    conv3x3x3_forward.launches += 1
    return out


def conv3x3x3_dx(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv's input gradient for the cotangent ``g`` (B, T, H, W, OC).
    CPU tensor: the plain version.  CUDA tensor: the kernel on the flipped,
    channel-transposed weights, or raise."""
    if not g.is_cuda:
        return conv3x3x3_dx_plain(g, weight)
    dx = _launch(g, conv_weight_t(weight.float()), None)
    conv3x3x3_dx.launches += 1
    return dx


class _FusedConv3x3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return conv3x3x3_forward(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            B, T, H, W, OC = g.shape
            if supports_shape(T, H, W, OC, weight.shape[1], B):
                dx = conv3x3x3_dx(g, weight)
            else:
                dx = conv3x3x3_dx_plain(g, weight, mxu_dtype=None)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv3d_weight(_ncthw(x.float()), weight.shape,
                                             _ncthw(g.float()), padding=1)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2, 3))
        return dx, dw, db


def fused_conv3x3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, W, C), weight (OC, C, 3, 3, 3), bias (OC,) -> (B, T, H, W,
    OC); differentiable.  The caller gates with :func:`supports_shape`, as
    the JAX package's ``Conv3x3x3`` does.  CPU tensor: the plain versions.
    CUDA tensor: the kernels, or raise."""
    return _FusedConv3x3x3.apply(x, weight, bias)


conv3x3x3_forward.launches = 0
conv3x3x3_dx.launches = 0
