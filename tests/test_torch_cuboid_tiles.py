"""What the general cuboid layer's forward (``csrc/attention.cu``: the axial
forward's TMA + wgmma products around ``cuboid_tc_core_kernel``) is handed,
on the CPU: the core's tiles of ``ops/attention.cuboid_layer_plan`` cover
every (cuboid, head, query row) once within a block's shared memory and a
thread's registers, wherever the layer took a shape before; the QKV
product's route by width; and a torch emulation of the forward's order of
arithmetic (bf16 LN rows, bf16 q . scale, k and v, the scores summed over
16-channel steps, p normalised then rounded to bf16, p . v summed over
16-key steps, bf16 head outputs, the projection) against the JAX package's
Pallas kernel in interpret mode, and with injected masks against
``cuboid_attention_dropout_plain``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_attention
from prediff_torch.ops import attention, weights
from prediff_torch.ops.attention import (attention_plan,
                                         cuboid_attention_dropout_plain, cuboid_layer_plan)
from prediff_torch.ops.ffn import layer_norm_plain

# (cuboids, vol, C, heads): the kernels line's general-layer shapes
# (video_swin_1x8: UNet B=1 and B=2 per stage, alignment net; vol 128 / 256),
# a width past the LN tile, and ragged vol
SHAPES = [(52, 64, 256, 4), (13, 64, 512, 4), (104, 64, 256, 4), (26, 64, 512, 4),
          (24, 64, 128, 4), (6, 64, 256, 4), (26, 128, 256, 4), (13, 256, 256, 4),
          (4, 64, 1024, 4), (5, 37, 192, 4), (3, 100, 128, 2)]
# bf16 operands rounded at the same points on both sides (see test_torch_axial_tiles.py)
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4
TOL_SUM_ORDER = 1e-5


@pytest.mark.parametrize("nC,vol,C,heads", SHAPES)
def test_core_tiles_cover_every_query_row_once(nC, vol, C, heads):
    core = cuboid_layer_plan(nC, vol, C, heads).core
    n, h, z = core.blocks
    assert (n, h) == (nC, heads) and core.rows in (16, 32, 64)
    seen = np.zeros((nC, heads, vol), dtype=np.int64)
    for c in range(n):
        for hd in range(h):
            for zi in range(z):
                for warp in range(core.rows // 16):
                    rows = core.tile(c, hd, zi, warp)
                    seen[c, hd, rows.start:rows.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("nC,vol,C,heads", SHAPES)
def test_core_tiles_fit_the_card(nC, vol, C, heads):
    core = cuboid_layer_plan(nC, vol, C, heads).core
    assert core.smem_bytes <= attention.GEMM_SMEM_CAP
    assert core.vol <= 64 * core.key_tiles and core.key_tiles in (1, 2, 4)
    assert core.hcp % 16 == 0 and core.hcp - 16 < core.hc <= core.hcp
    # (hcp + 8) / 8 odd: the fragment reads of 8 rows x 4 lanes hit 32 banks
    assert ((core.hcp + 8) // 8) % 2 == 1
    assert core.fragment_registers <= 160   # of the 255 a thread may hold


def test_core_tiles_at_the_swin_shapes():
    """64-row blocks: 208 at stage 0, 52 at stage 1; a ragged 37-row cuboid
    (48 rows of k and v with the zero rows) in blocks of 32 query rows, no
    larger than the cuboid."""
    s0 = cuboid_layer_plan(52, 64, 256, 4).core
    s1 = cuboid_layer_plan(13, 64, 512, 4).core
    assert (s0.rows, math.prod(s0.blocks)) == (64, 208)
    assert (s1.rows, math.prod(s1.blocks), s1.hcp) == (64, 52, 128)
    ragged = cuboid_layer_plan(5, 37, 192, 4).core
    assert (ragged.rows, ragged.blocks, ragged.vol16) == (32, (5, 4, 2), 48)


@pytest.mark.parametrize("vol", [1, 8, 37, 64, 100, 144, 200, 256])
@pytest.mark.parametrize("hc", [4, 8, 24, 32, 64, 128, 192, 196, 256, 512, 2048])
def test_no_shape_the_layer_took_is_refused(vol, hc):
    """Wherever the layer's first gate (the first gradient cores' query tile:
    8 rows at least beside the cuboid's bf16 k and v) took a cuboid, the
    forward's core fits too, and so does the backward's plan: the layer
    still takes it."""
    heads = 64 // math.gcd(hc, 64)
    if not any(4 * vol * (hc + 2) + 8 * rows * ((hc + 1) + (vol + 1)) <= attention.SMEM_BYTES
               for rows in (32, 16, 8)):
        return
    plan = cuboid_layer_plan(3, vol, hc * heads, heads)
    assert plan.core.smem_bytes <= attention.GEMM_SMEM_CAP
    assert attention.supports_cuboid(3, vol, hc * heads, heads)


def test_qkv_product_route_by_width():
    """The LN tile up to 768 channels (the axial plan's tiles); past it the
    product reads bf16 LN rows by TMA in 128 x 128 tiles."""
    for C in (128, 256, 512, 768):
        plan = cuboid_layer_plan(10, 64, C, 4)
        assert plan.qkv == attention_plan(640, C)[0] and plan.qkv.ln
    wide = cuboid_layer_plan(10, 64, 1024, 4)
    assert not wide.qkv.ln and wide.qkv.bn == 128 and wide.qkv.stages >= 2
    assert (wide.qkv.N, wide.qkv.K, wide.proj.N) == (3 * 1024, 1024, 1024)


def _gemm(a, w, plan):
    """out = a . w^T tile by tile, each tile's sum over 64-deep slices in order."""
    out = torch.empty(plan.M, plan.N)
    for m in range(plan.m_tiles):
        for n in range(plan.n_tiles):
            rows, cols = plan.tile(m, n)
            r, c = slice(rows.start, rows.stop), slice(cols.start, cols.stop)
            acc = torch.zeros(len(rows), len(cols))
            for k0 in range(0, plan.K, 64):
                acc = acc + a[r, k0:k0 + 64] @ w[c, k0:k0 + 64].T
            out[r, c] = acc
    return out


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulate(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, eps=1e-5, masks=None,
             rates=(0.0, 0.0)):
    """The forward's arithmetic on reordered (B, cuboids, vol, C) x: the QKV
    product on bf16 LN rows and the bf16 weight copy, q . scale, k, v rounded
    to bf16; per (cuboid, head) s summed over 16-channel steps + bias; the
    row max, then the sum of exp(s - max) tile by tile (64 keys); p = exp(s -
    max) / sum (m_a), rounded to bf16; p . v summed over 16-key
    steps, rounded to bf16; the projection on those, + b_proj (m_p)."""
    B, nC, vol, C = x.shape
    M, hc = B * nC * vol, C // heads
    plan = cuboid_layer_plan(B * nC, vol, C, heads)
    ln = _bf16(layer_norm_plain(x.reshape(M, C), ln_w, ln_b, eps))
    qkv = _gemm(ln, weights.linear_bf16(w_qkv).float(), plan.qkv)
    q, k, v = (_bf16(t).reshape(B, nC, vol, heads, hc).permute(0, 1, 3, 2, 4)
               for t in (qkv[:, :C] * scale, qkv[:, C:2 * C], qkv[:, 2 * C:]))
    s = torch.zeros(B, nC, heads, vol, vol)
    for c0 in range(0, hc, 16):
        s = s + q[..., c0:c0 + 16] @ k[..., c0:c0 + 16].transpose(-1, -2)
    s = s + bias
    m = s.amax(-1, keepdim=True)
    l = torch.zeros(s.shape[:-1] + (1,))
    for k0 in range(0, vol, 64):
        l = l + torch.exp(s[..., k0:k0 + 64] - m).sum(-1, keepdim=True)
    p = torch.exp(s - m) / l
    if masks is not None and rates[0] > 0:
        p = p * masks[0] / (1.0 - rates[0])
    p = _bf16(p)
    o = torch.zeros(B, nC, heads, vol, hc)
    for j0 in range(0, vol, 16):
        o = o + p[..., j0:j0 + 16] @ v[..., j0:j0 + 16, :]
    o = _bf16(o).permute(0, 1, 3, 2, 4).reshape(M, C)
    out = _gemm(o, weights.linear_bf16(w_proj).float(), plan.proj) + b_proj
    if masks is not None and rates[1] > 0:
        out = out * masks[1].reshape(M, C) / (1.0 - rates[1])
    return out.reshape(x.shape)


def _inputs(shape, heads, seed):
    rs = np.random.RandomState(seed)
    B, nC, vol, C = shape
    x = rs.randn(*shape).astype(np.float32)
    ln_s = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    ln_b = (0.1 * rs.randn(C)).astype(np.float32)
    w_qkv = (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32)   # flax layout (in, out)
    bias = (0.5 * rs.randn(heads, vol, vol)).astype(np.float32)
    w_proj = (rs.randn(C, C) / np.sqrt(C)).astype(np.float32)
    b_proj = (0.1 * rs.randn(C)).astype(np.float32)
    return x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj


def _torch_args(x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj):
    t = torch.from_numpy
    return (t(x), t(ln_s), t(ln_b), t(np.ascontiguousarray(w_qkv.T)), t(bias),
            t(np.ascontiguousarray(w_proj.T)), t(b_proj))


@pytest.mark.parametrize("shape", [(1, 8, 64, 128), (1, 2, 100, 128), (1, 2, 144, 128)])
def test_emulated_forward_matches_the_interpret_kernel(shape):
    """At the alignment net's head width (hc 32: a scale that is no power of
    two, so q . scale rounds); vol 64 (one key tile), vol 100 and 144 (two
    and three, ragged: the sum of exp added tile by tile)."""
    heads = 4
    args = _inputs(shape, heads, 80 + shape[2])
    scale = 32 ** -0.5
    want = np.asarray(pallas_attention.fused_cuboid_attention_layer_v4(
        *map(jnp.asarray, args), num_heads=heads, scale=scale, mxu_dtype_name="bfloat16",
        interpret=True))
    got = _emulate(*_torch_args(*args), heads, scale).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= TOL_BF16 * (1.0 + np.abs(want).max()), err.max()
    assert err.mean() <= MEAN_TOL_BF16, err.mean()


# one key tile (vol <= 64): the softmax's sum is the plain version's own; past
# it the tile-by-tile sum may differ by an ulp, enough to flip a bf16
# rounding of p (held to the interpret kernel at the bf16 bar above)
@pytest.mark.parametrize("shape,heads", [((2, 3, 64, 64), 2), ((1, 2, 48, 128), 4),
                                         ((1, 3, 37, 64), 2)])
def test_emulated_forward_with_masks_matches_the_plain_dropout(shape, heads):
    B, nC, vol, C = shape
    rates = (0.2, 0.1)
    t = _torch_args(*_inputs(shape, heads, 90 + vol))
    rs = np.random.RandomState(95 + vol)
    masks = (torch.from_numpy((rs.rand(B, nC, heads, vol, vol) >= rates[0]).astype(np.float32)),
             torch.from_numpy((rs.rand(*shape) >= rates[1]).astype(np.float32)))
    scale = (C // heads) ** -0.5
    got = _emulate(*t, heads, scale, masks=masks, rates=rates)
    want = cuboid_attention_dropout_plain(*t, heads, scale, mxu_dtype=torch.bfloat16,
                                          rate_attn=rates[0], rate_proj=rates[1], masks=masks)
    assert float((got - want).abs().max()) <= TOL_SUM_ORDER * float(want.abs().max())
