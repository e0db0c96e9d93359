"""Whole-resblock forward and input gradient: the port's plain versions
against the JAX reference, ``jax.vjp`` of it, and the interpret-mode Pallas
kernels, in f32 and with bf16 operands; the plain gradient against autograd;
the ``autograd.Function`` against autograd of the plain version (CPU).  The
CUDA kernels are held against the plain versions in
test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_resblock
from prediff_torch.ops.resblock import (fused_resblock, fused_resblock_bwd, fused_resblock_fwd,
                                        resblock_bwd_plain, resblock_plain)

# f32: another sum order only (two 3x3x3 convs over 27 C terms)
TOL_F32 = 1e-4
# bf16 operands rounded at the same points on both sides: a 1-ulp f32
# difference before a rounding can flip one bf16 value (2^-8 relative), so
# a few outputs move by up to ~1e-2 of the output scale; the mean stays ~1e-4.
TOL_BF16 = 1e-2
MEAN_TOL_BF16 = 2e-4
SHAPE = (1, 2, 4, 4, 128)   # the smallest shape tests/test_pallas_resblock.py runs
GROUPS = 32


def assert_bf16_close(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= TOL_BF16 * (1.0 + np.abs(want).max()), err.max()
    assert err.mean() <= MEAN_TOL_BF16, err.mean()


def _inputs(seed, shape=SHAPE):
    rs = np.random.RandomState(seed)
    B, T, H, W, C = shape
    f = np.float32
    return dict(
        x=(rs.randn(B, T, H, W, C) * 0.5).astype(f), emb=(rs.randn(B, C) * 0.3).astype(f),
        k1=(rs.randn(3, 3, 3, C, C) / np.sqrt(27 * C)).astype(f), b1=(0.1 * rs.randn(C)).astype(f),
        k2=(rs.randn(3, 3, 3, C, C) / np.sqrt(27 * C)).astype(f), b2=(0.1 * rs.randn(C)).astype(f),
        g1s=(1.0 + 0.1 * rs.randn(C)).astype(f), g1b=(0.1 * rs.randn(C)).astype(f),
        g2s=(1.0 + 0.1 * rs.randn(C)).astype(f), g2b=(0.1 * rs.randn(C)).astype(f))


def _jax_args(a):
    return [jnp.asarray(a[k]) for k in ("x", "emb", "k1", "b1", "k2", "b2", "g1s", "g1b",
                                        "g2s", "g2b")]


def _torch_args(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    for k in ("k1", "k2"):   # flax (3,3,3,I,O) -> torch Conv3d (O,I,3,3,3)
        t[k] = torch.from_numpy(np.ascontiguousarray(a[k].transpose(4, 3, 0, 1, 2)))
    return [t[k] for k in ("x", "emb", "k1", "b1", "k2", "b2", "g1s", "g1b", "g2s", "g2b")]


def _cotangent(seed, shape=SHAPE):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_plain_forward_matches_jax_reference():
    a = _inputs(0)
    want = np.asarray(pallas_resblock.resblock_reference(*_jax_args(a), groups=GROUPS))
    got, _ = resblock_plain(*_torch_args(a), groups=GROUPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_forward_matches_interpret_kernel(mxu):
    a = _inputs(1)
    out, h2 = pallas_resblock.fused_resblock(*_jax_args(a), groups=GROUPS, mxu_dtype_name=mxu,
                                             interpret=True)
    h2 = np.asarray(pallas_resblock._crop_rows(h2.astype(jnp.float32), *SHAPE[1:4]))
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got, got_h2 = resblock_plain(*_torch_args(a), groups=GROUPS, mxu_dtype=dtype)
    if dtype is None:
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=TOL_F32, atol=TOL_F32)
        np.testing.assert_allclose(got_h2.numpy(), h2, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got.numpy(), np.asarray(out))
        assert_bf16_close(got_h2.numpy(), h2)


def _jax_bwd(a, g, mxu):
    args = _jax_args(a)
    _, h2 = pallas_resblock.fused_resblock(*args, groups=GROUPS, mxu_dtype_name=mxu,
                                           interpret=True)
    x, emb, k1, _, k2, _, g1s, g1b, g2s, g2b = args
    dx, demb = pallas_resblock._fused_resblock_bwd(
        x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, jnp.asarray(g), groups=GROUPS,
        mxu_dtype_name=mxu, interpret=True)
    return np.asarray(dx), np.asarray(demb)


def _plain_bwd(a, g, dtype):
    x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b = _torch_args(a)
    _, h2 = resblock_plain(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, GROUPS, mxu_dtype=dtype)
    dx, demb = resblock_bwd_plain(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, torch.from_numpy(g),
                                  GROUPS, mxu_dtype=dtype)
    return dx.numpy(), demb.numpy()


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_bwd_matches_interpret_kernel(mxu):
    a, g = _inputs(2), _cotangent(3)
    want_dx, want_demb = _jax_bwd(a, g, mxu)
    got_dx, got_demb = _plain_bwd(a, g, torch.bfloat16 if mxu == "bfloat16" else None)
    if mxu == "float32":
        np.testing.assert_allclose(got_dx, want_dx, rtol=TOL_F32, atol=TOL_F32)
        # demb sums dv over all T*H*W tokens: a longer f32 sum
        np.testing.assert_allclose(got_demb, want_demb, rtol=TOL_F32, atol=TOL_F32 * 10)
    else:
        assert_bf16_close(got_dx, want_dx)
        assert_bf16_close(got_demb / np.abs(want_demb).max(), want_demb / np.abs(want_demb).max())


def test_plain_bwd_matches_jax_vjp_of_reference():
    a, g = _inputs(4), _cotangent(5)
    args = _jax_args(a)
    _, vjp = jax.vjp(lambda x, e: pallas_resblock.resblock_reference(x, e, *args[2:],
                                                                     groups=GROUPS),
                     args[0], args[1])
    want_dx, want_demb = vjp(jnp.asarray(g))
    got_dx, got_demb = _plain_bwd(a, g, None)
    np.testing.assert_allclose(got_dx, np.asarray(want_dx), rtol=TOL_F32, atol=TOL_F32)
    np.testing.assert_allclose(got_demb, np.asarray(want_demb), rtol=TOL_F32, atol=TOL_F32 * 10)


def _autograd_of_plain(targs, g):
    leaves = [t.clone().requires_grad_(True) for t in targs]
    out, _ = resblock_plain(*leaves, groups=GROUPS)
    return torch.autograd.grad(out, leaves, g)


def test_plain_bwd_matches_autograd_of_plain_forward():
    a, g = _inputs(6), torch.from_numpy(_cotangent(7))
    targs = _torch_args(a)
    want_dx, want_demb = _autograd_of_plain(targs, g)[:2]
    x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b = targs
    _, h2 = resblock_plain(*targs, groups=GROUPS)
    got_dx, got_demb = resblock_bwd_plain(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g, GROUPS)
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_demb, want_demb, rtol=1e-5, atol=1e-4)


def test_function_gives_plain_autograd_grads_on_cpu():
    a, g = _inputs(8, (1, 2, 3, 4, 64)), torch.from_numpy(_cotangent(9, (1, 2, 3, 4, 64)))
    targs = _torch_args(a)
    want = _autograd_of_plain(targs, g)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    before = (fused_resblock_fwd.launches, fused_resblock_bwd.launches)
    out = fused_resblock(*leaves, groups=GROUPS)
    torch.testing.assert_close(out, resblock_plain(*targs, groups=GROUPS)[0])
    got = torch.autograd.grad(out, leaves, g)
    for name, w, gt in zip(("x", "emb", "k1", "b1", "k2", "b2", "g1s", "g1b", "g2s", "g2b"),
                           want, got):
        torch.testing.assert_close(gt, w, rtol=1e-5, atol=1e-4, msg=name)
    assert (fused_resblock_fwd.launches, fused_resblock_bwd.launches) == before
    # only dx asked: the parameter gradients are not computed
    x = targs[0].clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(fused_resblock(x, *targs[1:], groups=GROUPS), x, g)
    torch.testing.assert_close(dx, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused_resblock_bwd(*targs[:3], targs[4], *targs[6:],
                                                  resblock_plain(*targs, groups=GROUPS)[1], g,
                                                  GROUPS)[0], want[0], rtol=1e-5, atol=1e-5)
