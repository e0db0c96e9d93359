"""Fused pre-norm FFN: ``x + W2 . gelu_erf(W1 . LN(x) + b1) + b2`` on (tokens, C).

The kernel (``csrc/ffn.cu``) replaces ``prediff_tpu/ops/pallas_ffn.py::fused_ffn``:
the hidden activation never leaves the chip, matrix products take bf16
operands with f32 accumulation on the tensor cores.  GELU uses the exact
``erff``; the TPU kernel's A&S 7.1.26 erf differs from it by at most 4e-7.
Weights are in PyTorch layout: ``w1`` (hidden, C), ``w2`` (C, hidden).
"""
from typing import Optional

import torch

from . import _build

_P, _I, _F = _build.P, _build.I, _build.F
_SIGNATURES = {"ffn_forward": [_P] * 9 + [_I] * 4 + [_F, _P]}
KERNEL_WIDTHS = (128, 256, 512)
_ROWS_PER_BLOCK = 32     # csrc/ffn.cu kRows
_CHUNK = 64              # csrc/ffn.cu kChunk
_TARGET_BLOCKS = 264     # two blocks for each of the H100's 132 SMs


def hidden_splits(M: int, hidden: int) -> int:
    """Splits of the hidden dimension: the fewest that give about
    ``_TARGET_BLOCKS`` blocks, among the divisors of hidden / 64."""
    row_blocks = -(-M // _ROWS_PER_BLOCK)
    chunks = hidden // _CHUNK
    for s in range(1, chunks + 1):
        if chunks % s == 0 and row_blocks * s >= _TARGET_BLOCKS:
            return s
    return chunks


def _round(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    return t if dtype is None else t.to(dtype).float()


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """Two-pass LayerNorm over the last axis, the kernels' arithmetic."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * weight + bias


def ffn_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, eps: float = 1e-5,
              mxu_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version.  ``mxu_dtype=torch.bfloat16`` rounds the matmul
    operands (LN output, weights, hidden) where the kernel does; ``None``
    keeps f32 throughout."""
    xf = x.float()
    ln = layer_norm_plain(xf, ln_w, ln_b, eps)
    h = _round(ln, mxu_dtype) @ _round(w1, mxu_dtype).T + b1
    h = torch.nn.functional.gelu(h)
    out = _round(h, mxu_dtype) @ _round(w2, mxu_dtype).T + b2
    return (xf + out).to(x.dtype)


def fused_ffn(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """CPU tensor: the plain version in f32.  CUDA tensor: the kernel, or raise."""
    if not x.is_cuda:
        return ffn_plain(x, ln_w, ln_b, w1, b1, w2, b2, eps)
    M, C = x.shape
    hidden = w1.shape[0]
    if C not in KERNEL_WIDTHS or hidden % 64 != 0:
        raise ValueError(f"ffn kernel: C={C} (takes {KERNEL_WIDTHS}), hidden={hidden} "
                         "(takes multiples of 64) not supported")
    _build.require("ffn", [("x", x, (M, C)), ("ln_w", ln_w, (C,)), ("ln_b", ln_b, (C,)),
                           ("w1", w1, (hidden, C)), ("b1", b1, (hidden,)),
                           ("w2", w2, (C, hidden)), ("b2", b2, (C,))])
    splits = hidden_splits(M, hidden)
    part = torch.empty((splits, M, C), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    lib = _build.load("ffn", _SIGNATURES)
    err = lib.ffn_forward(*(_build.ptr(t) for t in (x, ln_w, ln_b, w1, b1, w2, b2, part, out)),
                          M, C, hidden, splits, float(eps), _build.stream_ptr(x.device))
    _build.check(err, "ffn_forward")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0
