"""Axial whole-layer attention: the port's plain version against the JAX
cuboid reference and the interpret-mode Pallas kernel on all three axes,
its input gradient likewise, and the ``autograd.Function`` against autograd
of the plain version (CPU).  The CUDA kernels are held against the plain
versions in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import cuboid as jax_cuboid
from prediff_tpu.ops import pallas_attention
from prediff_torch.ops.attention import (axial_attention_bwd_dx_plain, axial_attention_plain,
                                         axial_cuboid_size, fused_axial_attention,
                                         fused_axial_attention_bwd_dx)

# f32: another sum order only
TOL_F32 = 1e-5
# bf16 operands rounded at the same points on both sides.  A 1-ulp f32
# difference before a rounding can flip one bf16 operand (2^-8 relative),
# which moves a few outputs by up to ~1e-2; the mean error stays ~1e-5.
TOL_BF16 = 1e-2
MEAN_TOL_BF16 = 1e-4


def assert_bf16_close(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= TOL_BF16 * (1.0 + np.abs(want).max()), err.max()
    assert err.mean() <= MEAN_TOL_BF16, err.mean()



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
def test_plain_matches_jax_cuboid_reference(axis):
    shape, heads = (2, 5, 4, 6, 32), 4
    x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj = _inputs(shape, heads, axis, axis)
    scale = (32 // heads) ** -0.5
    cs = axial_cuboid_size(shape, axis)
    xr = jax_cuboid.cuboid_reorder(jnp.asarray(x), cs, ("l", "l", "l"))
    out = pallas_attention.cuboid_layer_attention_reference(
        xr, *map(jnp.asarray, (ln_s, ln_b, w_qkv, bias, w_proj, b_proj)), heads, scale)
    want = np.asarray(jax_cuboid.cuboid_reorder_reverse(out, cs, ("l", "l", "l"), shape[1:4]))
    t = _torch_args(x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj)
    got = axial_attention_plain(t[0], axis, *t[1:], heads, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel(axis, mxu):
    shape, heads = (1, 5, 8, 8, 128), 4
    x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj = _inputs(shape, heads, axis, 10 + axis)
    scale = (128 // heads) ** -0.5
    want = np.asarray(pallas_attention.fused_axial_attention_5d(
        jnp.asarray(x), axis, *map(jnp.asarray, (ln_s, ln_b, w_qkv, bias, w_proj, b_proj)),
        num_heads=heads, scale=scale, mxu_dtype_name=mxu, interpret=True))
    t = _torch_args(x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = axial_attention_plain(t[0], axis, *t[1:], heads, scale, mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def test_wrapper_takes_plain_version_on_cpu():
    t = _torch_args(*_inputs((1, 3, 4, 4, 16), 2, 1, 20))
    before = fused_axial_attention.launches
    got = fused_axial_attention(t[0], 1, *t[1:], 2, 0.25)
    assert torch.equal(got, axial_attention_plain(t[0], 1, *t[1:], 2, 0.25))
    assert fused_axial_attention.launches == before


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_dx_matches_interpret_kernel(axis, mxu):
    shape, heads = (1, 5, 8, 8, 128), 4
    x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj = _inputs(shape, heads, axis, 30 + axis)
    g = np.random.RandomState(40 + axis).randn(*shape).astype(np.float32)
    scale = (128 // heads) ** -0.5
    want = np.asarray(pallas_attention.fused_axial_attention_5d_bwd_dx(
        jnp.asarray(x), jnp.asarray(g), axis,
        *map(jnp.asarray, (ln_s, ln_b, w_qkv, bias, w_proj)),
        num_heads=heads, scale=scale, mxu_dtype_name=mxu, interpret=True))
    t = _torch_args(x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = axial_attention_bwd_dx_plain(t[0], torch.from_numpy(g), axis, *t[1:6], heads, scale,
                                       mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def _autograd_of_plain(t, g, axis, heads, scale):
    leaves = [a.clone().requires_grad_(True) for a in t]
    out = axial_attention_plain(leaves[0], axis, *leaves[1:], heads, scale)
    return torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_plain_dx_matches_autograd_of_plain_forward(axis):
    shape, heads = (2, 5, 4, 6, 32), 4
    t = _torch_args(*_inputs(shape, heads, axis, 50 + axis))
    g = torch.from_numpy(np.random.RandomState(60 + axis).randn(*shape).astype(np.float32))
    want = _autograd_of_plain(t, g, axis, heads, 0.3)[0]
    got = axial_attention_bwd_dx_plain(t[0], g, axis, *t[1:6], heads, 0.3)
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)


def test_function_gives_plain_autograd_grads_on_cpu():
    shape, heads, axis = (1, 3, 4, 4, 16), 2, 0
    t = _torch_args(*_inputs(shape, heads, axis, 70))
    g = torch.from_numpy(np.random.RandomState(71).randn(*shape).astype(np.float32))
    want = _autograd_of_plain(t, g, axis, heads, 0.25)
    leaves = [a.clone().requires_grad_(True) for a in t]
    before = (fused_axial_attention.launches, fused_axial_attention_bwd_dx.launches)
    out = fused_axial_attention(leaves[0], axis, *leaves[1:], heads, 0.25)
    got = torch.autograd.grad(out, leaves, g)
    for name, w, gt in zip(("x", "ln_w", "ln_b", "w_qkv", "bias", "w_proj", "b_proj"), want, got):
        torch.testing.assert_close(gt, w, rtol=TOL_F32, atol=TOL_F32, msg=name)
    assert (fused_axial_attention.launches, fused_axial_attention_bwd_dx.launches) == before
