"""All-gradients backwards (the training path): each plain version of the
port against the interpret-mode Pallas kernel and against ``jax.vjp`` of the
JAX reference, in f32 and with bf16 matmul operands (CPU), and the
``autograd.Function``s taking them when a parameter gradient is asked for.
The CUDA kernels are held against these plain versions in
test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import cuboid as jax_cuboid
from prediff_tpu.ops import pallas_attention, pallas_ffn, pallas_groupnorm
from prediff_torch.ops.attention import (axial_attention_bwd_full_plain, axial_cuboid_size,
                                         fused_axial_attention, fused_axial_attention_bwd_dx,
                                         fused_axial_attention_bwd_full)
from prediff_torch.ops.ffn import (ffn_bwd_full_plain, fused_ffn, fused_ffn_bwd_dx,
                                   fused_ffn_bwd_full)
from prediff_torch.ops.groupnorm import (fused_groupnorm_silu, fused_groupnorm_silu_bwd_full,
                                         groupnorm_silu_bwd_full_plain)

# f32 on both sides: another sum order (and exact erf against the TPU kernel's
# A&S 7.1.26, <= 4e-7).  dx and the vector gradients to 1e-5 of the output's
# scale; a weight gradient sums tokens x width products, so 1e-4.
TOL_F32 = 1e-5
TOL_F32_DW = 1e-4
# bf16 operands rounded at the same points on both sides: a 1-ulp f32
# difference before a rounding can flip one bf16 operand (2^-8 relative),
# the bars of test_torch_ffn.py, relative to the output's scale.
TOL_BF16 = 1e-2
MEAN_TOL_BF16 = 1e-4

FFN_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
ATTN_NAMES = ("dx", "dgamma", "dbeta", "dwqkv", "dbias", "dwproj", "dbproj")


def assert_close(name, got, want, bf16):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want)
    scale = max(1.0, np.abs(want).max())
    if bf16:
        assert err.max() <= TOL_BF16 * scale, (name, err.max(), scale)
        assert err.mean() <= MEAN_TOL_BF16 * scale, (name, err.mean(), scale)
    else:
        tol = TOL_F32_DW if name.startswith("dw") else TOL_F32
        assert err.max() <= tol * scale, (name, err.max(), scale)


# ---- FFN ----
def _ffn_inputs(tokens, C, hidden, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(tokens, C) * 0.5).astype(np.float32),
            rs.randn(tokens, C).astype(np.float32),                     # cotangent
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32),       # flax layout (in, out)
            (0.1 * rs.randn(hidden)).astype(np.float32),
            (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32))


def _ffn_torch(x, g, ln_s, ln_b, w1, b1, w2):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)))


def _ffn_to_flax(grads):
    dx, dg, db, dw1, db1, dw2, db2 = (a.numpy() for a in grads)
    return dx, dg, db, dw1.T, db1, dw2.T, db2


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_ffn_plain_matches_interpret_kernel(mxu):
    args = _ffn_inputs(384, 128, 512, 0)   # tile 128: three grid steps accumulate
    want = pallas_ffn.fused_ffn_bwd_full(*map(jnp.asarray, args), mxu_dtype_name=mxu,
                                         interpret=True)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = _ffn_to_flax(ffn_bwd_full_plain(*_ffn_torch(*args), mxu_dtype=dtype))
    for name, a, b in zip(FFN_NAMES, got, want):
        assert_close(name, a, b, bf16=dtype is not None)


def test_ffn_plain_matches_vjp_of_jax_reference():
    x, g, ln_s, ln_b, w1, b1, w2 = _ffn_inputs(96, 64, 256, 1)
    b2 = np.zeros(64, np.float32)
    _, vjp = jax.vjp(pallas_ffn.fused_ffn_reference, *map(jnp.asarray, (x, ln_s, ln_b, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(g))
    got = _ffn_to_flax(ffn_bwd_full_plain(*_ffn_torch(x, g, ln_s, ln_b, w1, b1, w2)))
    for name, a, b in zip(FFN_NAMES, got, want):
        assert_close(name, a, b, bf16=False)


def test_ffn_function_takes_the_all_gradients_backward_for_parameters():
    x, g, *params = _ffn_torch(*_ffn_inputs(48, 64, 256, 2))
    b2 = torch.zeros(64)
    want = ffn_bwd_full_plain(x, g, *params)
    leaves = [t.clone().requires_grad_(True) for t in (x, *params, b2)]
    before = (fused_ffn.launches, fused_ffn_bwd_dx.launches, fused_ffn_bwd_full.launches)
    got = torch.autograd.grad(fused_ffn(*leaves), leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)      # on the CPU the Function returns the plain version's
    assert torch.equal(fused_ffn_bwd_full(x, g, *params)[0], want[0])
    # only a frozen model's input gradient goes the dx-only way
    leaves = [x.clone().requires_grad_(True), *params, b2]
    (dx,) = torch.autograd.grad(fused_ffn(*leaves), leaves[:1], g)
    torch.testing.assert_close(dx, want[0], rtol=TOL_F32, atol=TOL_F32)
    assert (fused_ffn.launches, fused_ffn_bwd_dx.launches, fused_ffn_bwd_full.launches) == before


# ---- axial attention ----
def _attn_inputs(shape, heads, axis, seed):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    return ((rs.randn(*shape) * 0.5).astype(np.float32), rs.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),      # flax layout (in, out)
            (0.3 * rs.randn(heads, vol, vol)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32))


def _attn_torch(x, g, ln_s, ln_b, w_qkv, bias, w_proj):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w_qkv.T)), t(bias),
            t(np.ascontiguousarray(w_proj.T)))


def _attn_to_flax(grads):
    dx, dg, db, dwqkv, dbias, dwproj, dbproj = (a.numpy() for a in grads)
    return dx, dg, db, dwqkv.T, dbias, dwproj.T, dbproj


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_attention_plain_matches_interpret_kernel(axis, mxu):
    shape, heads = (2, 5, 8, 8, 128), 4     # B = 2: the grid accumulates across samples
    x, g, ln_s, ln_b, w_qkv, bias, w_proj = _attn_inputs(shape, heads, axis, 10 + axis)
    scale = (128 // heads) ** -0.5
    want = pallas_attention.fused_axial_attention_5d_bwd_full(
        jnp.asarray(x), jnp.asarray(g), axis,
        *map(jnp.asarray, (ln_s, ln_b, w_qkv, bias, w_proj)),
        num_heads=heads, scale=scale, mxu_dtype_name=mxu, interpret=True)
    t = _attn_torch(x, g, ln_s, ln_b, w_qkv, bias, w_proj)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = _attn_to_flax(axial_attention_bwd_full_plain(t[0], t[1], axis, *t[2:], heads, scale,
                                                       mxu_dtype=dtype))
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert_close(name, a, b, bf16=dtype is not None)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_plain_matches_vjp_of_jax_reference(axis):
    shape, heads = (2, 5, 4, 6, 32), 4
    x, g, ln_s, ln_b, w_qkv, bias, w_proj = _attn_inputs(shape, heads, axis, 20 + axis)
    b_proj = np.zeros(32, np.float32)
    cs = axial_cuboid_size(shape, axis)

    def ref(x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj):
        xr = jax_cuboid.cuboid_reorder(x, cs, ("l", "l", "l"))
        o = pallas_attention.cuboid_layer_attention_reference(xr, ln_s, ln_b, w_qkv, bias,
                                                              w_proj, b_proj, heads, 0.3)
        return jax_cuboid.cuboid_reorder_reverse(o, cs, ("l", "l", "l"), shape[1:4])

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj)))
    want = vjp(jnp.asarray(g))
    t = _attn_torch(x, g, ln_s, ln_b, w_qkv, bias, w_proj)
    got = _attn_to_flax(axial_attention_bwd_full_plain(t[0], t[1], axis, *t[2:], heads, 0.3))
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert_close(name, a, b, bf16=False)


def test_attention_function_takes_the_all_gradients_backward_for_parameters():
    shape, heads, axis = (1, 3, 4, 4, 16), 2, 0
    x, g, *params = _attn_torch(*_attn_inputs(shape, heads, axis, 30))
    b_proj = torch.zeros(16)
    want = axial_attention_bwd_full_plain(x, g, axis, *params, heads, 0.25)
    leaves = [t.clone().requires_grad_(True) for t in (x, *params, b_proj)]
    before = (fused_axial_attention_bwd_dx.launches, fused_axial_attention_bwd_full.launches)
    out = fused_axial_attention(leaves[0], axis, *leaves[1:], heads, 0.25)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(fused_axial_attention_bwd_full(x, g, axis, *params, heads, 0.25)[4], want[4])
    assert (fused_axial_attention_bwd_dx.launches,
            fused_axial_attention_bwd_full.launches) == before


# ---- GroupNorm + SiLU ----
def _gn_inputs(B, N, C, seed, with_emb):
    rs = np.random.RandomState(seed)
    return ((rs.randn(B, N, C) * 2.0 + 3.0).astype(np.float32),           # |mean| > std
            rs.randn(B, N, C).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            rs.randn(B, C).astype(np.float32) if with_emb else None)


def _opt(fn, a):
    return None if a is None else fn(a)


@pytest.mark.parametrize("with_emb", [False, True])
def test_groupnorm_plain_matches_interpret_kernel(with_emb):
    x, g, w, b, emb = _gn_inputs(3, 64, 128, 40, with_emb)   # B = 3: dgamma / dbeta accumulate
    want = pallas_groupnorm.fused_groupnorm_silu_bwd_full(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(w), jnp.asarray(b),
        emb=_opt(jnp.asarray, emb), groups=32, interpret=True)
    got = groupnorm_silu_bwd_full_plain(*(_opt(torch.from_numpy, a) for a in (x, g, w, b, emb)),
                                        groups=32)
    assert (got[3] is None) == (want[3] is None) == (emb is None)
    for name, a, bb in zip(("dx", "dgamma", "dbeta", "demb"), got, want):
        if a is not None:
            assert_close(name, a.numpy(), bb, bf16=False)


@pytest.mark.parametrize("B,N,C,groups", [(2, 96, 64, 32), (1, 40, 65, 65), (2, 52, 96, 32)])
@pytest.mark.parametrize("with_emb", [False, True])
def test_groupnorm_plain_matches_vjp_of_jax_reference(B, N, C, groups, with_emb):
    x, g, w, b, emb = _gn_inputs(B, N, C, 41, with_emb)
    if with_emb:
        _, vjp = jax.vjp(lambda *a: pallas_groupnorm.fused_groupnorm_silu_reference(
            a[0], a[1], a[2], emb=a[3], groups=groups), *map(jnp.asarray, (x, w, b, emb)))
    else:
        _, vjp = jax.vjp(lambda *a: pallas_groupnorm.fused_groupnorm_silu_reference(
            *a, groups=groups), *map(jnp.asarray, (x, w, b)))
    want = vjp(jnp.asarray(g))
    got = groupnorm_silu_bwd_full_plain(*(_opt(torch.from_numpy, a) for a in (x, g, w, b, emb)),
                                        groups=groups)
    for name, a, bb in zip(("dx", "dgamma", "dbeta", "demb"), got, want):
        assert_close(name, a.numpy(), bb, bf16=False)


def test_groupnorm_function_backward_is_the_all_gradients_version():
    x, g, w, b, emb = (torch.from_numpy(a) for a in _gn_inputs(2, 48, 64, 42, True))
    want = groupnorm_silu_bwd_full_plain(x, g, w, b, emb, groups=32)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b, emb)]
    before = fused_groupnorm_silu_bwd_full.launches
    got = torch.autograd.grad(fused_groupnorm_silu(*leaves, groups=32), leaves, g)
    for a, bb in zip(got, want):
        assert torch.equal(a, bb)
    assert fused_groupnorm_silu_bwd_full.launches == before
