"""What the general cuboid layer's backward (``csrc/attention.cu``
``cuboid_bwd_launches``) is handed, on the CPU: the plan of
``ops/attention.cuboid_bwd_plan`` (the axial backward's products and weight
gradients around a gradient core on the tensor cores: one fused launch per
(cuboids, head) where a whole cuboid fits a block, else the query-row and
key-row pair) covers every (token, column), every (cuboid, head, row) and
every weight-gradient element once, within the card's shared memory and
registers, at every shape the layer took before; and a torch emulation of
its order of arithmetic (bf16 LN(x), q . scale, k, v, do, dattn, p, ds,
dqkv and head outputs at the TPU kernel's points, the dbias partials in
block order, the weight gradients over 64-token slices in rank order)
against the JAX package's Pallas kernels in interpret mode and, with
injected masks, against ``cuboid_attention_bwd_full_plain``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ffn_bwd_tiles import _wgrad

from prediff_tpu.ops import pallas_attention
from prediff_torch.ops import attention, weights, wgrad
from prediff_torch.ops.attention import cuboid_attention_bwd_full_plain, cuboid_bwd_plan
from prediff_torch.ops.ffn import layer_norm_bwd_plain, layer_norm_plain

# (cuboids, vol, C, heads): video_swin_1x8's training and guidance shapes (vol 64,
# fused), vol 128 / 256 (split), ragged and wide ones
SHAPES = [(104, 64, 256, 4), (26, 64, 512, 4), (24, 64, 128, 4), (13, 128, 256, 4),
          (13, 256, 256, 4), (5, 40, 192, 16), (3, 17, 64, 4), (2, 100, 832, 4),
          (4, 16, 1024, 4)]
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4   # the bars of tests/test_torch_bwd_full.py
TOL_SUM_ORDER = 1e-5
ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbias", "dwproj", "dbproj")


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_output_once_and_fits(shape):
    n, vol, C, heads = shape
    plan = cuboid_bwd_plan(n, vol, C, heads)
    M = n * vol
    for gp, N, K in ((plan.qkv, 3 * C, C), (plan.dattn, C, C), (plan.dln, C, 3 * C)):
        assert (gp.M, gp.N, gp.K) == (M, N, K)
        seen = np.zeros((M, N), dtype=np.int64)
        for m in range(gp.m_tiles):
            for t in range(gp.n_tiles):
                rows, cols = gp.tile(m, t)
                seen[rows.start:rows.stop, cols.start:cols.stop] += 1
        assert (seen == 1).all()
        assert 2 <= gp.stages and gp.smem_bytes <= attention.GEMM_SMEM_CAP
    assert plan.qkv.ln == (C <= attention.LN_MAX_K)
    assert plan.fused == (vol <= 64 and plan.core_smem <= attention.GEMM_SMEM_CAP)
    # the core: every (cuboid, head, row) once as a query row and once as a key
    warps = plan.vol16 // 16 if plan.fused else plan.rows // 16
    seen = np.zeros((n, heads, vol), dtype=np.int64)
    part_of = np.full(n, -1)
    grid = plan.grid
    for x in range(grid[0]):
        for h in range(grid[1]):
            for z in range(1 if plan.fused else grid[2]):
                for c in plan.block_cuboids(x):
                    part_of[c] = x
                    for w in range(warps):
                        r = plan.warp_rows(z, w)
                        seen[c, h, r.start:r.stop] += 1
    assert (seen == 1).all()
    # the dbias partials: each cuboid in exactly one, in order
    assert list(part_of) == sorted(part_of) and part_of.max() + 1 == plan.parts
    assert plan.core_smem <= attention.GEMM_SMEM_CAP and plan.fragment_registers <= 224
    assert plan.ld == wgrad.token_ld(M) and plan.ld % 64 == 0
    for wp, P in ((plan.wgrad_qkv, 3 * C), (plan.wgrad_proj, C)):
        assert (wp.P, wp.Q, wp.M) == (P, C, M)


def _first_design_admits(vol, hc):
    """The shapes the layer took before: the forward core's tiles and the
    first gradient cores' (a query tile of 8 rows at least beside the
    cuboid's bf16 k and v; any key tile of 1 fits where that does)."""
    hcp, vol16 = -(-hc // 16) * 16, -(-vol // 16) * 16
    forward = any(2 * (hcp + 8) * (2 * vol16 + rows) <= attention.GEMM_SMEM_CAP
                  for rows in (64, 32, 16) if rows <= vol16)
    query = any(4 * vol * (hc + 2) + 8 * rows * ((hc + 1) + (vol + 1)) <= attention.SMEM_BYTES
                for rows in (32, 16, 8))
    return forward and query


def test_plans_admit_every_shape_the_layer_took():
    """No shape changes route: wherever the first design launched, the new
    one does (a grid of vol and head widths, with each vol's widest head)."""
    admitted = 0
    for vol in (1, 7, 16, 17, 33, 48, 64, 65, 96, 100, 128, 129, 192, 200, 256):
        widths = [16, 24, 32, 40, 64, 96, 128, 160, 192, 256, 384, 512, 640, 768, 1024, 1806]
        widths.append(max(hc for hc in range(1, 2500) if _first_design_admits(vol, hc)))
        for hc in widths:
            if not _first_design_admits(vol, hc):
                continue
            heads = 64 // math.gcd(hc, 64)
            C = hc * heads
            assert attention.supports_cuboid(3, vol, C, heads), (vol, hc)
            plan = cuboid_bwd_plan(3, vol, C, heads)
            assert plan.core_smem <= attention.GEMM_SMEM_CAP
            admitted += 1
    assert admitted >= 150


def _bf(t):
    return t.to(torch.bfloat16).float()


def _emulate(x, g, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale, eps=1e-5, masks=None,
             rates=(0.0, 0.0)):
    """The launches' arithmetic on x (B, cuboids, vol, C): bf16 LN(x) .
    Wqkv^T into bf16 q . scale, k, v; do = g (masked) in bf16; dattn = do .
    Wproj in bf16; the core per (cuboid, head): p = exp(s - max) / sum, dp
    masked, D = rowsum(dp p), ds = p (dp - D), dq = bf16(ds) . k . scale,
    dk = bf16(ds)^T . q, dv = bf16(p_d)^T . dattn, all in bf16, the head
    outputs bf16(bf16(p_d) . v); dln = dqkv . Wqkv; the LayerNorm backward;
    dbias over the plan's partials (a block's cuboids in order, then the
    partials in order); the vector gradients in 8-row partials; the weight
    gradients of ``_wgrad``."""
    B, nC, vol, C = x.shape
    M, hc, n = B * nC * vol, C // heads, B * nC
    plan = cuboid_bwd_plan(n, vol, C, heads)
    m_a, m_p = masks if masks is not None else (None, None)
    do = g if m_p is None or rates[1] == 0 else g * m_p / (1.0 - rates[1])
    dob = _bf(do)
    ln = _bf(layer_norm_plain(x, ln_w, ln_b, eps))
    qkv = (ln @ weights.linear_bf16(w_qkv).float().T).reshape(B, nC, vol, 3, heads, hc)
    q, k, v = _bf(qkv[..., 0, :, :] * scale), _bf(qkv[..., 1, :, :]), _bf(qkv[..., 2, :, :])
    dattn = _bf(dob @ weights.linear_t_bf16(w_proj).float().T.contiguous()).reshape(
        B, nC, vol, heads, hc)
    s = torch.einsum("bnihc,bnjhc->bnhij", q, k) + bias
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
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
    dqkv = _bf(torch.stack([dq, dk, dv], dim=3).reshape(M, 3 * C))
    attn = _bf(torch.einsum("bnhij,bnjhc->bnihc", _bf(p_d), v).reshape(M, C))
    dln = dqkv @ weights.linear_t_bf16(w_qkv).float().T.contiguous()
    xf = x.reshape(M, C)
    dx = layer_norm_bwd_plain(xf, ln_w, dln, eps)
    dsf = ds.reshape(n, heads, vol, vol)
    dbias = None
    for x0 in range(plan.grid[0]):
        part = None
        for c in plan.block_cuboids(x0):
            part = dsf[c] if part is None else part + dsf[c]
        dbias = part if dbias is None else dbias + part
    mu = xf.mean(dim=-1, keepdim=True)
    nhat = (xf - mu) * torch.rsqrt((xf - mu).square().mean(dim=-1, keepdim=True) + eps)
    vec = None
    do_n = do.reshape(M, C)
    for r in range(0, M, 8):
        v3 = torch.stack([(dln[r:r + 8] * nhat[r:r + 8]).sum(0), dln[r:r + 8].sum(0),
                          do_n[r:r + 8].sum(0)])
        vec = v3 if vec is None else vec + v3
    dw_qkv = _wgrad(dqkv.T, ln.reshape(M, C).T, M)
    dw_proj = _wgrad(dob.reshape(M, C).T, attn.T, M)
    return dx.reshape(x.shape), vec[0], vec[1], dw_qkv, dbias, dw_proj, vec[2]


def _inputs(shape, heads, seed):
    rs = np.random.RandomState(seed)
    B, nC, vol, C = shape
    return ((rs.randn(*shape) * 0.5).astype(np.float32), rs.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),      # flax layout (in, out)
            (0.3 * rs.randn(heads, vol, vol)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32))


def _torch_args(x, g, ln_s, ln_b, w_qkv, bias, w_proj):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w_qkv.T)), t(bias),
            t(np.ascontiguousarray(w_proj.T)))


def _close(name, a, b):
    a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
    err, scale_b = np.abs(a - b), max(1.0, np.abs(b).max())
    assert err.max() <= TOL_BF16 * scale_b, (name, err.max(), scale_b)
    assert err.mean() <= MEAN_TOL_BF16 * scale_b, (name, err.mean(), scale_b)


# the fused core (vol 16) and the split pair (vol 80: two key tiles)
@pytest.mark.parametrize("shape", [(2, 3, 16, 128), (1, 2, 80, 64)])
def test_emulated_backward_matches_the_interpret_kernels(shape):
    heads = 4
    args = _inputs(shape, heads, 60 + shape[2])
    scale = (shape[3] // heads) ** -0.5
    jargs = (jnp.asarray(args[0]), jnp.asarray(args[1]), *map(jnp.asarray, args[2:]))
    want = pallas_attention.fused_cuboid_attention_layer_v4_bwd_full(
        *jargs, num_heads=heads, scale=scale, mxu_dtype_name="bfloat16", interpret=True)
    want_dx = pallas_attention.fused_cuboid_attention_layer_v4_bwd_dx(
        *jargs, num_heads=heads, scale=scale, mxu_dtype_name="bfloat16", interpret=True)
    t = _torch_args(*args)
    got = _emulate(*t, heads, scale)
    flax = (got[0], got[1], got[2], got[3].T, got[4], got[5].T, got[6])
    for name, a, b in zip(ATTN_NAMES, flax, want):
        _close(name, a, b)
    _close("dx only", got[0], want_dx)


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_emulated_backward_with_masks_matches_the_plain_dropout(rates):
    shape, heads = (2, 3, 16, 64), 4
    B, nC, vol, C = shape
    t = _torch_args(*_inputs(shape, heads, 70))
    rs = np.random.RandomState(71)
    m_a = torch.from_numpy((rs.rand(B, nC, heads, vol, vol) >= rates[0]).astype(np.float32))
    m_p = torch.from_numpy((rs.rand(*shape) >= rates[1]).astype(np.float32))
    scale = (C // heads) ** -0.5
    got = _emulate(*t, heads, scale, masks=(m_a, m_p), rates=rates)
    want = cuboid_attention_bwd_full_plain(*t, heads, scale, mxu_dtype=torch.bfloat16,
                                           rate_attn=rates[0], rate_proj=rates[1],
                                           masks=(m_a, m_p))
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert float((a - b).abs().max()) <= TOL_SUM_ORDER * float(b.abs().max()), name
