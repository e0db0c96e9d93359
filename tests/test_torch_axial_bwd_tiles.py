"""What the axial attention all-gradients backward (``csrc/attention.cu``
``axial_bwd_launches``) is handed, on the CPU: the plan of
``ops/attention.axial_bwd_plan`` (the forward's LN + QKV product, the dattn
and dln products on the transposed weights, the core's blocks, the two
weight-gradient products) covers every (token, column), every (cuboid, head)
and every weight-gradient element once, within the card's shared memory and
registers, at every shape the first design took; and a torch emulation of
its order of arithmetic (bf16 LN(x), q . scale, k, v, do, dattn, p, ds, dqkv
and head outputs at the TPU kernel's points, the weight gradients over
64-token slices added in rank order on the width-major operands, the dbias
and vector partials in block order) against the JAX package's Pallas kernel
in interpret mode on each axis and, with injected masks, against
``axial_attention_bwd_full_plain``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ffn_bwd_tiles import _wgrad, test_weight_gradient_plan_covers_every_element_once

from prediff_tpu.ops import pallas_attention
from prediff_torch.ops import attention, weights, wgrad
from prediff_torch.ops.attention import (axial_attention_bwd_full_plain, axial_bwd_plan,
                                         axial_cuboid_size)
from prediff_torch.ops.cuboid import cuboid_reorder, cuboid_reorder_reverse
from prediff_torch.ops.ffn import layer_norm_bwd_plain, layer_norm_plain

# (B, T, H, W, C): the training shapes (B=2 per stage), the alignment net's, ragged ones
SHAPES = [(2, 13, 16, 16, 256), (2, 13, 8, 8, 512), (1, 6, 16, 16, 128), (1, 6, 8, 8, 256),
          (2, 5, 3, 7, 64), (1, 3, 5, 2, 768), (1, 4, 3, 2, 832)]
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4   # the bars of tests/test_torch_bwd_full.py
TOL_SUM_ORDER = 1e-5
ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbias", "dwproj", "dbproj")
AXIAL = ("l", "l", "l")


def test_the_weight_gradient_plans_are_the_ffns():
    """The axial backward's weight gradients take the same product
    (``tests/test_torch_ffn_bwd_tiles.py`` covers its plan)."""
    test_weight_gradient_plan_covers_every_element_once(3 * 256, 256, 6656)
    test_weight_gradient_plan_covers_every_element_once(512, 512, 1664)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_plan_covers_every_output_once_and_fits(shape, axis):
    B, T, H, W, C = shape
    M, vol, heads = B * T * H * W, (T, H, W)[axis], 4
    plan = axial_bwd_plan(M, C, vol, heads)
    for gp, N, K in ((plan.qkv, 3 * C, C), (plan.dattn, C, C), (plan.dln, C, 3 * C)):
        assert (gp.M, gp.N, gp.K) == (M, N, K)
        seen = np.zeros((M, N), dtype=np.int64)
        for m in range(gp.m_tiles):
            for n in range(gp.n_tiles):
                rows, cols = gp.tile(m, n)
                seen[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (seen == 1).all()
        assert 2 <= gp.stages and gp.smem_bytes <= attention.GEMM_SMEM_CAP
        assert gp.accumulators <= 128
    assert plan.qkv.ln == (C <= attention.LN_MAX_K)
    # the core: every (cuboid, head) once, in blocks of per_block cuboids
    n_cuboids = M // vol
    cuboids = [c for b in range(plan.core_blocks)
               for c in range(b * plan.per_block, min(n_cuboids, (b + 1) * plan.per_block))]
    assert cuboids == list(range(n_cuboids))
    assert plan.core_smem <= attention.SMEM_BYTES
    assert plan.ld == wgrad.token_ld(M) and plan.ld % 64 == 0
    for wp, P in ((plan.wgrad_qkv, 3 * C), (plan.wgrad_proj, C)):
        assert (wp.P, wp.Q, wp.M) == (P, C, M)


def test_plans_admit_every_shape_the_first_design_took():
    """C a multiple of 64 (past the forward's LN tile too), any vol whose
    core fits shared memory."""
    admitted = 0
    for C in (64, 128, 192, 256, 512, 768, 832, 1024):
        for vol in (1, 8, 13, 16, 64, 100):
            # the wrapper's check, the first design's: the core's f32 tiles fit shared memory
            if attention._axial_refusal((1, vol, 2, 3, C), 0, 4, forward=False) is not None:
                continue
            admitted += 1
            plan = axial_bwd_plan(6 * vol, C, vol, 4)
            assert plan.core_smem <= attention.SMEM_BYTES
            assert all(gp.stages >= 2 for gp in (plan.qkv, plan.dattn, plan.dln))
    assert admitted >= 40


def _bf(t):
    return t.to(torch.bfloat16).float()


def _emulate(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale, eps=1e-5, masks=None,
             rates=(0.0, 0.0)):
    """The launches' arithmetic on the axis's cuboids: bf16 LN(x) . Wqkv^T
    into bf16 q . scale, k, v; do = g (masked) in bf16; dattn = do . Wproj in
    bf16; the core per cuboid (p, dp masked, ds = p (dp - rowsum(dp p)), bf16
    ds, dq dk dv in bf16, the dropped p's head outputs in bf16); dln = dqkv .
    Wqkv; the LayerNorm backward; dbias summed over the core's blocks in
    order; the weight gradients of ``_wgrad`` on the natural token order."""
    B, T, H, W, C = x.shape
    vol, M, hc = (T, H, W)[axis], B * T * H * W, C // heads
    plan = axial_bwd_plan(M, C, vol, heads)
    cs = axial_cuboid_size(x.shape, axis)
    m_a, m_p = masks if masks is not None else (None, None)
    do = g if m_p is None or rates[1] == 0 else g * m_p / (1.0 - rates[1])
    dob = _bf(do)
    xr, dor = cuboid_reorder(x, cs, AXIAL), cuboid_reorder(dob, cs, AXIAL)
    nC = xr.shape[1]
    ln = _bf(layer_norm_plain(xr, ln_w, ln_b, eps))
    qkv = (ln @ weights.linear_bf16(w_qkv).float().T).reshape(B, nC, vol, 3, heads, hc)
    q, k, v = _bf(qkv[..., 0, :, :] * scale), _bf(qkv[..., 1, :, :]), _bf(qkv[..., 2, :, :])
    # W_proj's bf16 transpose, read back as W_proj: the same product as the plain version's
    dattn = _bf(dor @ weights.linear_t_bf16(w_proj).float().T.contiguous()).reshape(
        B, nC, vol, heads, hc)
    s = torch.einsum("bnihc,bnjhc->bnhij", q, k) + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))   # the core's: exp(s - max), then / sum
    p = p / p.sum(dim=-1, keepdim=True)
    dp = torch.einsum("bnihc,bnjhc->bnhij", dattn, v)
    p_d = p
    if m_a is not None and rates[0] > 0:
        dp = dp * m_a / (1.0 - rates[0])
        p_d = p * m_a / (1.0 - rates[0])
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bnhij,bnjhc->bnihc", _bf(ds), k) * scale
    dk = torch.einsum("bnhij,bnihc->bnjhc", _bf(ds), q)
    dv = torch.einsum("bnhij,bnihc->bnjhc", _bf(p_d), dattn)
    dqkv = _bf(torch.stack([dq, dk, dv], dim=3).reshape(B, nC, vol, 3 * C))
    attn = _bf(torch.einsum("bnhij,bnjhc->bnihc", _bf(p_d), v).reshape(B, nC, vol, C))
    dln = dqkv @ weights.linear_t_bf16(w_qkv).float().T.contiguous()
    dx = layer_norm_bwd_plain(xr, ln_w, dln, eps)
    dsf = ds.reshape(B * nC, heads, vol, vol)
    dbias = None
    for b in range(plan.core_blocks):
        part = torch.zeros(heads, vol, vol)
        for c in range(b * plan.per_block, min(B * nC, (b + 1) * plan.per_block)):
            part = part + dsf[c]
        dbias = part if dbias is None else dbias + part
    mu = xr.mean(dim=-1, keepdim=True)
    nhat = (xr - mu) * torch.rsqrt((xr - mu).square().mean(dim=-1, keepdim=True) + eps)

    def natural(t):
        return cuboid_reorder_reverse(t, cs, AXIAL, (T, H, W)).reshape(M, -1)

    vec = None
    dln_n, nhat_n, do_n = natural(dln), natural(nhat), do.reshape(M, C)
    for r in range(0, M, 32):
        v3 = torch.stack([(dln_n[r:r + 32] * nhat_n[r:r + 32]).sum(0), dln_n[r:r + 32].sum(0),
                          do_n[r:r + 32].sum(0)])
        vec = v3 if vec is None else vec + v3
    dw_qkv = _wgrad(natural(dqkv).T, natural(ln).T, M)
    dw_proj = _wgrad(dob.reshape(M, C).T, natural(attn).T, M)
    return (cuboid_reorder_reverse(dx, cs, AXIAL, (T, H, W)), vec[0], vec[1], dw_qkv, dbias,
            dw_proj, vec[2])


def _inputs(shape, heads, axis, seed):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    return ((rs.randn(*shape) * 0.5).astype(np.float32), rs.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),      # flax layout (in, out)
            (0.3 * rs.randn(heads, vol, vol)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32))


def _torch_args(x, g, ln_s, ln_b, w_qkv, bias, w_proj):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w_qkv.T)), t(bias),
            t(np.ascontiguousarray(w_proj.T)))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_emulated_backward_matches_the_interpret_kernel(axis):
    shape, heads = (2, 5, 8, 8, 128), 4
    args = _inputs(shape, heads, axis, 40 + axis)
    scale = (128 // heads) ** -0.5
    want = pallas_attention.fused_axial_attention_5d_bwd_full(
        jnp.asarray(args[0]), jnp.asarray(args[1]), axis, *map(jnp.asarray, args[2:]),
        num_heads=heads, scale=scale, mxu_dtype_name="bfloat16", interpret=True)
    t = _torch_args(*args)
    got = _emulate(t[0], t[1], axis, *t[2:], heads, scale)
    flax = (got[0], got[1], got[2], got[3].T, got[4], got[5].T, got[6])
    for name, a, b in zip(ATTN_NAMES, flax, want):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        err, scale_b = np.abs(a - b), max(1.0, np.abs(b).max())
        assert err.max() <= TOL_BF16 * scale_b, (name, err.max(), scale_b)
        assert err.mean() <= MEAN_TOL_BF16 * scale_b, (name, err.mean(), scale_b)


@pytest.mark.parametrize("axis", [0, 2])
@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_emulated_backward_with_masks_matches_the_plain_dropout(axis, rates):
    shape, heads = (2, 5, 3, 7, 64), 4
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    t = _torch_args(*_inputs(shape, heads, axis, 50 + axis))
    rs = np.random.RandomState(51)
    m_a = torch.from_numpy((rs.rand(B, T * H * W // vol, heads, vol, vol) >= rates[0])
                           .astype(np.float32))
    m_p = torch.from_numpy((rs.rand(*shape) >= rates[1]).astype(np.float32))
    scale = (C // heads) ** -0.5
    got = _emulate(t[0], t[1], axis, *t[2:], heads, scale, masks=(m_a, m_p), rates=rates)
    want = axial_attention_bwd_full_plain(t[0], t[1], axis, *t[2:], heads, scale,
                                          mxu_dtype=torch.bfloat16, rate_attn=rates[0],
                                          rate_proj=rates[1], masks=(m_a, m_p))
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert float((a - b).abs().max()) <= TOL_SUM_ORDER * float(b.abs().max()), name
