"""What the axial attention forward's products (``csrc/attention.cu``
``fwd_gemm_kernel``) are handed, on the CPU: the plans of
``ops/attention.attention_plan`` cover every (token, column) of the QKV
product and of the output projection once, within the card's shared memory
and registers; and a torch emulation of the forward's order of arithmetic
(bf16 LN rows, the products over 64-deep slices per output tile, bf16
q . scale, k and v, the per-cuboid core, bf16 head outputs) against the JAX
package's Pallas kernel in interpret mode on each axis, and with injected
masks against ``axial_attention_plain``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_attention
from prediff_torch.ops import attention, weights
from prediff_torch.ops.attention import attention_plan, axial_attention_plain
from prediff_torch.ops.ffn import layer_norm_plain

# the attention shapes of the kernels line (tokens, width: UNet B=1 and B=2 per
# stage, alignment net) and ragged token counts
SHAPES = [(3328, 256), (832, 512), (6656, 256), (1664, 512), (1536, 128), (384, 256),
          (105, 64), (60, 192), (77, 768)]
# bf16 operands rounded at the same points on both sides (see test_torch_ffn_tiles.py)
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4
TOL_SUM_ORDER = 1e-5


@pytest.mark.parametrize("M,C", SHAPES)
def test_plans_cover_every_output_once(M, C):
    for plan, N in zip(attention_plan(M, C), (3 * C, C)):
        assert (plan.M, plan.N, plan.K) == (M, N, C)
        seen = np.zeros((M, N), dtype=np.int64)
        for m in range(plan.m_tiles):
            for n in range(plan.n_tiles):
                rows, cols = plan.tile(m, n)
                seen[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("M,C", SHAPES)
def test_plans_fit_the_card(M, C):
    qkv, proj = attention_plan(M, C)
    assert qkv.ln and not proj.ln
    for plan in (qkv, proj):
        assert plan.bn in (128, 256)
        assert 2 <= plan.stages <= attention.GEMM_MAX_STAGES
        assert plan.smem_bytes <= attention.GEMM_SMEM_CAP
        assert plan.accumulators <= 128   # of the 168 registers a thread at 288 threads
        assert plan.m_tiles <= 65535


def test_plans_at_the_unet_shapes():
    """The QKV product in 128 x 256 tiles at stage 0 (78 blocks), 128 x 128
    at stage 1 (the 128 KB LN tile leaves no room for 256-row weight tiles:
    84 blocks); the projections in 128 x 128."""
    s0, p0 = attention_plan(3328, 256)
    s1, p1 = attention_plan(832, 512)
    assert (s0.bn, s0.m_tiles * s0.n_tiles, s0.stages) == (256, 78, 4)
    assert (s1.bn, s1.m_tiles * s1.n_tiles, s1.stages) == (128, 84, 4)
    assert (p0.bn, p0.m_tiles * p0.n_tiles, p1.m_tiles * p1.n_tiles) == (128, 52, 28)


def test_plan_refuses_rows_wider_than_the_ln_tile():
    with pytest.raises(ValueError, match="LayerNorm tile"):
        attention_plan(128, 832)


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


def _emulate(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, eps=1e-5,
             masks=None, rates=(0.0, 0.0)):
    """The forward's arithmetic on natural (B, T, H, W, C) x: the QKV product
    on bf16 LN rows with the bf16 weight copy, q . scale, k and v rounded to
    bf16; per cuboid of the axis and head the f32 scores + bias, softmax
    (m_a), bf16 p, p . v rounded to bf16; the projection on those and the
    bf16 w_proj copy, + b_proj (m_p)."""
    B, T, H, W, C = x.shape
    M, hc = B * T * H * W, C // heads
    qkv_plan, proj_plan = attention_plan(M, C)
    ln = _bf16(layer_norm_plain(x.reshape(M, C), ln_w, ln_b, eps))
    qkv = _gemm(ln, weights.linear_bf16(w_qkv).float(), qkv_plan)
    q, k, v = _bf16(qkv[:, :C] * scale), _bf16(qkv[:, C:2 * C]), _bf16(qkv[:, 2 * C:])

    def cuboids(t):   # (M, C) -> (B, cuboids, vol, heads, hc), the axis's cuboids in order
        t = t.reshape(B, T, H, W, C).movedim(1 + axis, 3)
        return t.reshape(B, -1, t.shape[3], heads, hc)

    qc, kc, vc = cuboids(q), cuboids(k), cuboids(v)
    s = torch.einsum("bnihc,bnjhc->bnhij", qc, kc) + bias
    p = torch.softmax(s, dim=-1)
    if masks is not None and rates[0] > 0:
        p = p * masks[0] / (1.0 - rates[0])
    o = _bf16(torch.einsum("bnhij,bnjhc->bnihc", _bf16(p), vc))
    dims = [T, H, W]
    vol = dims.pop(axis)
    o = o.reshape(B, *dims, vol, C).movedim(3, 1 + axis).reshape(M, C)
    out = _gemm(o, weights.linear_bf16(w_proj).float(), proj_plan) + b_proj
    if masks is not None and rates[1] > 0:
        out = out * masks[1].reshape(M, C) / (1.0 - rates[1])
    return out.reshape(x.shape)


def _inputs(shape, heads, axis, seed):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
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


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_emulated_forward_matches_the_interpret_kernel(axis):
    """At the alignment net's head width (hc 32: a scale that is no power of
    two, so q . scale rounds) on a token count that leaves a ragged last tile
    (5 x 8 x 8 = 320)."""
    shape, heads = (1, 5, 8, 8, 128), 4
    args = _inputs(shape, heads, axis, 30 + axis)
    scale = (128 // heads) ** -0.5
    want = np.asarray(pallas_attention.fused_axial_attention_5d(
        jnp.asarray(args[0]), axis, *map(jnp.asarray, args[1:]), num_heads=heads, scale=scale,
        mxu_dtype_name="bfloat16", interpret=True))
    t = _torch_args(*args)
    got = _emulate(t[0], axis, *t[1:], heads, scale).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= TOL_BF16 * (1.0 + np.abs(want).max()), err.max()
    assert err.mean() <= MEAN_TOL_BF16, err.mean()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_emulated_forward_with_masks_matches_the_plain_dropout(axis):
    shape, heads, rates = (2, 3, 4, 5, 64), 2, (0.2, 0.1)
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    t = _torch_args(*_inputs(shape, heads, axis, 40 + axis))
    rs = np.random.RandomState(50 + axis)
    masks = (torch.from_numpy((rs.rand(B, T * H * W // vol, heads, vol, vol)
                               >= rates[0]).astype(np.float32)),
             torch.from_numpy((rs.rand(*shape) >= rates[1]).astype(np.float32)))
    scale = (C // heads) ** -0.5
    got = _emulate(t[0], axis, *t[1:], heads, scale, masks=masks, rates=rates)
    want = axial_attention_plain(t[0], axis, *t[1:], heads, scale, mxu_dtype=torch.bfloat16,
                                 rate_attn=rates[0], rate_proj=rates[1], masks=masks)
    assert float((got - want).abs().max()) <= TOL_SUM_ORDER * float(want.abs().max())
