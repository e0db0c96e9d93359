"""Fused FFN: the port's plain version against the JAX reference and the
interpret-mode Pallas kernel (f32 and bf16 matmul operands, CPU); the CUDA
kernel is held against the plain version in test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_ffn
from prediff_torch.ops.ffn import ffn_plain, fused_ffn

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

