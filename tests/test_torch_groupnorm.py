"""GroupNorm(+emb)+SiLU: the port's plain version against the JAX reference
and the interpret-mode Pallas kernel, and the ``autograd.Function``'s
gradients (CPU).  The CUDA kernel is held against the plain version in
test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_groupnorm
from prediff_torch.ops.groupnorm import fused_groupnorm_silu, groupnorm_silu_plain

# f32 on both sides; the sums run in another order
TOL = 1e-5



def _inputs(B, N, C, seed, with_emb):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, N, C) * 2.0 + 3.0).astype(np.float32)  # |mean| > std
    w = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    emb = rs.randn(B, C).astype(np.float32) if with_emb else None
    return x, w, b, emb


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("B,N,C,groups", [(2, 96, 64, 32), (1, 40, 65, 65), (2, 52, 128, 32)])
@pytest.mark.parametrize("with_emb", [False, True])
def test_plain_matches_jax_reference(B, N, C, groups, with_emb):
    x, w, b, emb = _inputs(B, N, C, 0, with_emb)
    want = np.asarray(pallas_groupnorm.fused_groupnorm_silu_reference(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if emb is None else jnp.asarray(emb), groups=groups))
    got = groupnorm_silu_plain(*map(_torch, (x, w, b, emb)), groups=groups).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_emb", [False, True])
def test_plain_matches_interpret_kernel(with_emb):
    x, w, b, emb = _inputs(2, 64, 128, 1, with_emb)
    want = np.asarray(pallas_groupnorm.fused_groupnorm_silu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if emb is None else jnp.asarray(emb), groups=32, interpret=True))
    got = groupnorm_silu_plain(*map(_torch, (x, w, b, emb)), groups=32).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_wrapper_takes_plain_version_on_cpu():
    x, w, b, emb = map(_torch, _inputs(1, 32, 64, 2, True))
    before = fused_groupnorm_silu.launches
    out = fused_groupnorm_silu(x, w, b, emb, groups=32)
    assert torch.equal(out, groupnorm_silu_plain(x, w, b, emb, groups=32))
    assert fused_groupnorm_silu.launches == before


@pytest.mark.parametrize("with_emb", [False, True])
def test_function_gives_plain_autograd_grads_on_cpu(with_emb):
    """On the CPU the backward is the plain all-gradients version: it gives
    what autograd of the plain forward gives, and dx matches jax.vjp of the
    JAX reference."""
    x, w, b, emb = _inputs(2, 48, 64, 3, with_emb)
    g = np.random.RandomState(4).randn(2, 48, 64).astype(np.float32)
    targs = [_torch(a) for a in (x, w, b, emb)]
    want_leaves = [None if a is None else a.clone().requires_grad_(True) for a in targs]
    got_leaves = [None if a is None else a.clone().requires_grad_(True) for a in targs]
    used = [a for a in want_leaves if a is not None]
    want = torch.autograd.grad(groupnorm_silu_plain(*want_leaves, groups=32), used,
                               torch.from_numpy(g))
    got = torch.autograd.grad(fused_groupnorm_silu(*got_leaves, groups=32),
                              [a for a in got_leaves if a is not None], torch.from_numpy(g))
    for w_, g_ in zip(want, got):
        torch.testing.assert_close(g_, w_, rtol=TOL, atol=TOL)
    _, vjp = jax.vjp(lambda xx: pallas_groupnorm.fused_groupnorm_silu_reference(
        xx, jnp.asarray(w), jnp.asarray(b), None if emb is None else jnp.asarray(emb),
        groups=32), jnp.asarray(x))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=TOL, atol=TOL)
