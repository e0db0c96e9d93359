"""Axial whole-layer attention on the natural (B, T, H, W, C) layout.

``LN -> . Wqkv^T -> per head softmax(q . scale . k^T + relbias[h]) . v ->
. Wproj^T + b`` along one axis (0: T, 1: H, 2: W), with no residual.  The
kernel (``csrc/attention.cu``) replaces
``prediff_tpu/ops/pallas_attention.py::fused_axial_attention_5d``.  It runs
as three hand-written launches (LN+QKV product, the per-cuboid core, the
output projection) that read cuboids in place by strides; matrix products
take bf16 operands with f32 accumulation.  Weights are in PyTorch layout:
``w_qkv`` (3C, C), ``w_proj`` (C, C); ``bias`` is (heads, vol, vol).
"""
from typing import Optional

import torch

from . import _build
from .cuboid import cuboid_reorder, cuboid_reorder_reverse
from .ffn import _round, layer_norm_plain

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {"axial_attention_forward": [_P] * 10 + [_I] * 7 + [_F, _F, _P]}


def axial_cuboid_size(shape, axis: int):
    _, T, H, W, _ = shape
    return ((T, 1, 1), (1, H, 1), (1, 1, W))[axis]


def axial_attention_plain(x: torch.Tensor, axis: int, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                          b_proj: torch.Tensor, num_heads: int, scale: float,
                          eps: float = 1e-5,
                          mxu_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version, through ``cuboid_reorder``.  ``mxu_dtype``
    rounds the matmul operands where the kernel does; ``None`` keeps f32."""
    B, T, H, W, C = x.shape
    hc = C // num_heads
    cs = axial_cuboid_size(x.shape, axis)
    xr = cuboid_reorder(x.float(), cs, ("l", "l", "l"))          # (B, nC, vol, C)
    nC, vol = xr.shape[1], xr.shape[2]
    ln = layer_norm_plain(xr, ln_w, ln_b, eps)
    qkv = (_round(ln, mxu_dtype) @ _round(w_qkv, mxu_dtype).T).reshape(B, nC, vol, 3, num_heads, hc)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    s = torch.einsum("bnihc,bnjhc->bnhij", _round(q * scale, mxu_dtype), _round(k, mxu_dtype))
    s = s + bias
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bnhij,bnjhc->bnihc", _round(p, mxu_dtype), _round(v, mxu_dtype))
    o = o.reshape(B, nC, vol, C)
    out = _round(o, mxu_dtype) @ _round(w_proj, mxu_dtype).T + b_proj
    return cuboid_reorder_reverse(out, cs, ("l", "l", "l"), (T, H, W)).to(x.dtype)


def fused_axial_attention(x: torch.Tensor, axis: int, ln_w: torch.Tensor, ln_b: torch.Tensor,
                          w_qkv: torch.Tensor, bias: torch.Tensor, w_proj: torch.Tensor,
                          b_proj: torch.Tensor, num_heads: int, scale: float,
                          eps: float = 1e-5) -> torch.Tensor:
    """CPU tensor: the plain version in f32.  CUDA tensor: the kernel, or raise."""
    if not x.is_cuda:
        return axial_attention_plain(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj,
                                     num_heads, scale, eps)
    B, T, H, W, C = x.shape
    vol = (T, H, W)[axis]
    if C % 64 != 0 or C % num_heads != 0 or axis not in (0, 1, 2):
        raise ValueError(f"attention kernel: C={C} (takes multiples of 64), heads={num_heads}, "
                         f"axis={axis} not supported")
    smem = 4 * (3 * vol * (C // num_heads + 1) + vol * vol)
    if smem > 227 * 1024:
        raise ValueError(f"attention kernel: cuboid of {vol} rows x {C // num_heads} head "
                         "channels exceeds shared memory")
    _build.require("attention", [
        ("x", x, (B, T, H, W, C)), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
        ("w_qkv", w_qkv, (3 * C, C)), ("bias", bias, (num_heads, vol, vol)),
        ("w_proj", w_proj, (C, C)), ("b_proj", b_proj, (C,))])
    M = B * T * H * W
    qkv = torch.empty((M, 3 * C), dtype=torch.float32, device=x.device)
    attn = torch.empty((M, C), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load("attention", _SIGNATURES)
    err = lib.axial_attention_forward(
        *(_build.ptr(t) for t in (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, qkv, attn, out)),
        B, T, H, W, C, axis, num_heads, float(scale), float(eps), _build.stream_ptr(x.device))
    _build.check(err, "axial_attention_forward")
    fused_axial_attention.launches += 1
    return out


fused_axial_attention.launches = 0
