"""Fused FFN: the port's plain version against the JAX reference and the
interpret-mode Pallas kernel (f32 and bf16 matmul operands, CPU), its input
gradient likewise, and the ``autograd.Function`` against autograd of the
plain version (the all-gradients backward has its own file,
test_torch_bwd_full.py); the CUDA kernels are held against the plain versions
in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_ffn
from prediff_torch.ops.ffn import ffn_bwd_dx_plain, ffn_plain, fused_ffn, fused_ffn_bwd_dx

# f32: exact erf here vs the TPU's A&S 7.1.26 (<= 4e-7) and another sum order
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



def _inputs(tokens, C, hidden, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(tokens, C) * 0.5).astype(np.float32)
    ln_s = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    ln_b = (0.1 * rs.randn(C)).astype(np.float32)
    w1 = (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32)    # flax layout (in, out)
    b1 = (0.1 * rs.randn(hidden)).astype(np.float32)
    w2 = (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.1 * rs.randn(C)).astype(np.float32)
    return x, ln_s, ln_b, w1, b1, w2, b2


def _torch_args(x, ln_s, ln_b, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(x), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("tokens,C,hidden", [(64, 32, 128), (96, 128, 512)])
def test_plain_matches_jax_reference(tokens, C, hidden):
    args = _inputs(tokens, C, hidden, 0)
    want = np.asarray(pallas_ffn.fused_ffn_reference(*map(jnp.asarray, args)))
    got = ffn_plain(*_torch_args(*args)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_matches_interpret_kernel(mxu):
    args = _inputs(128, 128, 512, 1)
    want = np.asarray(pallas_ffn.fused_ffn(*map(jnp.asarray, args), mxu_dtype_name=mxu,
                                           interpret=True))
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = ffn_plain(*_torch_args(*args), mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def test_wrapper_takes_plain_version_on_cpu():
    args = _torch_args(*_inputs(32, 64, 256, 2))
    before = fused_ffn.launches
    assert torch.equal(fused_ffn(*args), ffn_plain(*args))
    assert fused_ffn.launches == before


def _cotangent(tokens, C, seed):
    return np.random.RandomState(seed).randn(tokens, C).astype(np.float32)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_plain_dx_matches_interpret_kernel(mxu):
    args = _inputs(128, 128, 512, 3)
    g = _cotangent(128, 128, 4)
    want = np.asarray(pallas_ffn.fused_ffn_bwd_dx(
        *map(jnp.asarray, (args[0], g) + args[1:6]), mxu_dtype_name=mxu, interpret=True))
    x, ln_s, ln_b, w1, b1, w2, _ = _torch_args(*args)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = ffn_bwd_dx_plain(x, torch.from_numpy(g), ln_s, ln_b, w1, b1, w2,
                           mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def _autograd_of_plain(targs, g):
    leaves = [t.clone().requires_grad_(True) for t in targs]
    return torch.autograd.grad(ffn_plain(*leaves), leaves, g)


def test_plain_dx_matches_autograd_of_plain_forward():
    targs = _torch_args(*_inputs(64, 128, 512, 5))
    g = torch.from_numpy(_cotangent(64, 128, 6))
    want = _autograd_of_plain(targs, g)[0]
    got = ffn_bwd_dx_plain(targs[0], g, *targs[1:6])
    torch.testing.assert_close(got, want, rtol=TOL_F32, atol=TOL_F32)


def test_function_gives_plain_autograd_grads_on_cpu():
    targs = _torch_args(*_inputs(48, 64, 256, 7))
    g = torch.from_numpy(_cotangent(48, 64, 8))
    want = _autograd_of_plain(targs, g)
    leaves = [t.clone().requires_grad_(True) for t in targs]
    before = (fused_ffn.launches, fused_ffn_bwd_dx.launches)
    got = torch.autograd.grad(fused_ffn(*leaves), leaves, g)
    for name, w, gt in zip(("x", "ln_w", "ln_b", "w1", "b1", "w2", "b2"), want, got):
        torch.testing.assert_close(gt, w, rtol=TOL_F32, atol=TOL_F32, msg=name)
    assert (fused_ffn.launches, fused_ffn_bwd_dx.launches) == before
