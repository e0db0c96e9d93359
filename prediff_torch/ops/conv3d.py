"""The UNet's 3x3x3 stride-1 SAME convolution + bias with bf16 operands, on
channel-last (B, T, H, W, C) f32, weights in PyTorch ``Conv3d`` layout
(OC, C, 3, 3, 3):

    out = conv(bf16(x), bf16(w)) + b        (f32 accumulation, f32 out)

The kernel (``csrc/conv3d.cu``: TMA and wgmma on Hopper) replaces
``prediff_tpu/ops/pallas_conv3d.py::fused_conv3x3x3``, the opt-in route of
the JAX package's ``Conv3x3x3`` (``use_pallas_conv=True``).
:func:`fused_conv3x3x3` is differentiable as the JAX package's
``fused_conv3x3x3_diff`` is: dx is the same kernel on the cotangent with the
flipped, channel-transposed weights where :func:`supports_shape` admits the
cotangent's shape, else the f32 transposed conv; dw is the f32 weight
gradient from the unrounded x; db the f32 sum of the cotangent.

What the kernel is handed is plain Python here, so the CPU tests reach it:
:func:`conv_plan` (the token box, the tiles and the cluster split) and
:func:`weight_layout` (the bf16 weights laid out once per parameter version,
in the cache of ``ops/weights.py``).
"""
import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build, weights
from .ffn import _round

_P, _I = _build.P, _build.I
_SIGNATURES = {"conv3x3x3_forward": [_P] * 5 + [_I] * 11 + [_P],
               "conv3x3x3_forward_bf16": [_P] * 4 + [_I] * 11 + [_P],
               "conv3x3x3_weight_map": [_P, _I, _I, _I, _P], **weights.MAP_SIGNATURE}
# the JAX package's VMEM budget of its routing rule (prediff_tpu/ops/dispatch.py)
VMEM_BUDGET_BYTES = 12 * 1024 * 1024
# csrc/conv_wgmma.cuh: kBM tokens (one box) x 256, 128 or 64 output channels
# a block, K in slices of kBK
TOKEN_TILE, K_SLICE = 128, 64
SMS = 132   # the H100's SMs: one block each (the ring takes most of an SM's shared memory)
SPLITS = (1, 2, 4, 8)   # cluster sizes that pack into the H100's GPCs (3, 5 or 6 do not)


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
    of the CUDA kernel, which takes any C that is a multiple of 64 and OC of
    128 (the rule admits multiples of 128 only)."""
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


@_build.widened
def conv3x3x3_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                    mxu_dtype: Optional[torch.dtype] = torch.bfloat16) -> torch.Tensor:
    """Plain version: x and the weights rounded to ``mxu_dtype`` (``None``
    keeps f32), an f32 conv, the bias in f32; out in x's dtype."""
    out = _nthwc(F.conv3d(_ncthw(_round(x.float(), mxu_dtype)),
                          _round(weight.float(), mxu_dtype), padding=1))
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


@_build.widened
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


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@dataclass(frozen=True)
class ConvPlan:
    """What the kernel is handed for a conv of (B, T, H, W) tokens, K -> N
    channels: the token box (bt, bh, bw) of ``TOKEN_TILE`` tokens, the boxes
    per axis, the output-channel tile (256, 128 or 64) and how
    many blocks of a cluster split the 27 x K / ``K_SLICE`` slices of the
    reduction."""
    B: int
    T: int
    H: int
    W: int
    K: int
    N: int
    box: tuple
    boxes: tuple
    n_tile: int
    splits: int

    @property
    def n_tiles(self) -> int:
        return self.N // self.n_tile

    @property
    def m_tiles(self) -> int:
        return self.B * self.boxes[0] * self.boxes[1] * self.boxes[2]

    @property
    def slices(self) -> int:
        return 27 * self.K // K_SLICE

    def origin(self, m_tile: int):
        """(sample, t0, h0, w0) of a token tile, in the kernel's order."""
        nbt, nbh, nbw = self.boxes
        bt, bh, bw = self.box
        iw, rest = m_tile % nbw, m_tile // nbw
        ih, rest = rest % nbh, rest // nbh
        return rest // nbt, (rest % nbt) * bt, ih * bh, iw * bw

    def split_slices(self, rank: int) -> range:
        """The (tap, channel slice) indices, tap-major, that block ``rank`` of
        a cluster adds."""
        return range(rank * self.slices // self.splits, (rank + 1) * self.slices // self.splits)


@lru_cache(maxsize=None)
def conv_plan(B: int, T: int, H: int, W: int, K: int, N: int) -> ConvPlan:
    """The standalone conv's plan (:func:`conv_tiles`), for the channels its
    entry point takes (N a multiple of 128)."""
    if K % K_SLICE or N % 128 or min(B, T, H, W, K, N) < 1:
        raise ValueError(f"conv3x3x3 kernel: {K} -> {N} channels not supported "
                         f"(K % {K_SLICE} == 0, N % 128 == 0)")
    return conv_tiles(B, T, H, W, K, N)


@lru_cache(maxsize=None)
def conv_tiles(B: int, T: int, H: int, W: int, K: int, N: int) -> ConvPlan:
    """The kernel's tiles (``csrc/conv_wgmma.cuh``, which the resblock shares):
    the box is as wide as W (to a power of two, at most the tile), then as
    high as H, then deep in t to fill ``TOKEN_TILE`` tokens; the output-channel
    tile the widest of 256, 128, 64 dividing N whose blocks fill half the SMs
    (a narrower tile re-reads each token box, so no narrower than that; 64
    where none does); the most splits of ``SPLITS`` that keep every block in
    one wave over the ``SMS`` SMs (a second wave would double the time)."""
    if K % K_SLICE or N % 64 or min(B, T, H, W, K, N) < 1:
        raise ValueError(f"conv kernel: {K} -> {N} channels not supported "
                         f"(K % {K_SLICE} == 0, N % 64 == 0)")
    bw = min(_pow2_at_least(W), TOKEN_TILE)
    bh = min(_pow2_at_least(H), TOKEN_TILE // bw)
    bt = TOKEN_TILE // (bw * bh)
    boxes = (-(-T // bt), -(-H // bh), -(-W // bw))
    slices = 27 * K // K_SLICE
    plans = []
    for n_tile in (t for t in (256, 128, 64) if N % t == 0):
        tiles = B * boxes[0] * boxes[1] * boxes[2] * (N // n_tile)
        splits = max(s for s in SPLITS if s == 1 or (s <= slices and tiles * s <= SMS))
        plans.append(ConvPlan(B, T, H, W, K, N, (bt, bh, bw), boxes, n_tile, splits))
    return next((p for p in plans if p.m_tiles * p.n_tiles * p.splits >= SMS // 2), plans[-1])


def _forward_layout(k: torch.Tensor) -> torch.Tensor:
    return conv_weight(k).transpose(1, 2)


def _dx_layout(k: torch.Tensor) -> torch.Tensor:
    return conv_weight_t(k).transpose(1, 2)


def weight_layout(weight: torch.Tensor, dx: bool = False) -> torch.Tensor:
    """The kernel's bf16 weights, K-contiguous (27, N, K): the forward's
    ``[tap][out][in]`` (``conv_weight`` transposed), or with ``dx`` the input
    gradient's flipped ``[tap][in][out]`` (``conv_weight_t`` transposed).
    Laid out once per parameter version by the shared cache of
    ``ops/weights.py`` (an update through ``weight.data`` is not seen)."""
    return weights.layout(weight, *_KINDS[dx])


_KINDS = {False: ("conv", _forward_layout), True: ("conv_dx", _dx_layout)}


def weight_map(weight: torch.Tensor, dx: bool, n_tile: int):
    """The cached layout and its TMA tensor map (128 bytes, made on first use
    for each output-channel tile: boxes of ``n_tile`` rows)."""
    def encode(layout):
        _, N, K = layout.shape
        lib = _build.load("conv3d", _SIGNATURES)
        desc = ctypes.create_string_buffer(128)
        _build.check(lib.conv3x3x3_weight_map(_build.ptr(layout), N, K, n_tile, desc),
                     "conv3x3x3_weight_map")
        return desc

    return weights.tensor_map(weight, *_KINDS[dx], n_tile, encode)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            dx: bool) -> torch.Tensor:
    """The kernel on x (B, T, H, W, K) with ``weight``'s cached layout: x
    and out f32 (x rounded to bf16 by a launch of its own), or bf16 (the
    bf16 form: x the operand as it is, out rounded once)."""
    B, T, H, W, K = x.shape
    N = weight.shape[1] if dx else weight.shape[0]
    plan = conv_plan(B, T, H, W, K, N)
    form = _build.io_form("conv3x3x3", x)
    bias = weights.f32(bias)
    specs = [("x", x, (B, T, H, W, K), x.dtype)]
    if bias is not None:
        specs.append(("bias", bias, (N,)))
    _build.require("conv3x3x3", specs)
    if tuple(weight.shape) != ((K, N) if dx else (N, K)) + (3, 3, 3) or not weight.is_cuda:
        raise ValueError(f"conv3x3x3 kernel: weight {tuple(weight.shape)} on {weight.device} "
                         f"does not fit x {tuple(x.shape)} -> {N} channels")
    if x.data_ptr() % 16:
        raise ValueError("conv3x3x3 kernel: x must be 16-byte aligned")
    layout, desc = weight_map(weight, dx, plan.n_tile)
    out = torch.empty((B, T, H, W, N), dtype=x.dtype, device=x.device)
    lib = _build.load("conv3d", _SIGNATURES)
    bias_p = None if bias is None else _build.ptr(bias)
    dims = (B, T, H, W, K, N, plan.n_tile, *plan.box, plan.splits, _build.stream_ptr(x.device))
    if form:
        err = lib.conv3x3x3_forward_bf16(_build.ptr(x), desc, bias_p, _build.ptr(out), *dims)
    else:
        xb = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
        err = lib.conv3x3x3_forward(_build.ptr(x), _build.ptr(xb), desc, bias_p, _build.ptr(out),
                                    *dims)
    _build.check(err, "conv3x3x3_forward" + form)
    return out, form


def conv3x3x3_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The conv's forward.  CPU tensor: the plain version (the same bf16
    rounding).  CUDA tensor: the kernel, or raise."""
    if not _build.on_card(conv3x3x3_forward, x):
        return conv3x3x3_plain(x, weight, bias)
    out, form = _launch(x, weight, bias, dx=False)
    _build.count(conv3x3x3_forward, form)
    return out


def conv3x3x3_dx(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The conv's input gradient for the cotangent ``g`` (B, T, H, W, OC).
    CPU tensor: the plain version.  CUDA tensor: the kernel on the flipped,
    channel-transposed weights, or raise."""
    if not _build.on_card(conv3x3x3_dx, g):
        return conv3x3x3_dx_plain(g, weight)
    dx, form = _launch(g, weight, None, dx=True)
    _build.count(conv3x3x3_dx, form)
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
    if _build.needs_grad(x, weight, bias):
        return _FusedConv3x3x3.apply(x, weight, bias)
    return conv3x3x3_forward(x, weight, bias)


conv3x3x3_forward.launches = conv3x3x3_forward.bf16_launches = 0
conv3x3x3_dx.launches = conv3x3x3_dx.bf16_launches = 0
