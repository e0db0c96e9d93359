"""The FFN kernels' activations (relu, leaky, silu and gelu): the port's
plain versions against the JAX package's ``fused_ffn_reference(...,
activation=)`` and ``jax.vjp`` of it, one interpret-mode ``fused_ffn_bwd_full``
and one interpret-mode ``fused_ffn_dropout`` case (with its backward) at C =
128, and the wrappers' refusal of any other name (CPU).  The CUDA kernels are
held against these plain versions in test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_dropout import hash_mask, jax_masks  # noqa: F401  (a fixture)

from prediff_tpu.ops import pallas_ffn
from prediff_torch.ops import ffn

# f32 on both sides: the exact erf here vs the TPU's A&S 7.1.26 (<= 4e-7),
# expf vs XLA's exp, and another sum order
TOL = 1e-5
ACTS = ("gelu", "relu", "leaky", "silu")


def _inputs(tokens, C, hidden, seed):
    """x, g, the LayerNorm affine, w1, b1, w2, b2 (flax layouts), with h
    spread over both signs."""
    rs = np.random.RandomState(seed)
    return ((rs.randn(tokens, C) * 0.5).astype(np.float32),
            rs.randn(tokens, C).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(hidden)).astype(np.float32),
            (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32))


def _torch(x, g, ln_s, ln_b, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


def _close(name, got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (name, np.abs(got - want).max(), scale)


NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


def _port_grads(grads):
    """The port's (dx, dln_w, dln_b, dw1, db1, dw2, db2) in the flax layouts."""
    dx, dg, db, dw1, db1, dw2, db2 = (a.numpy() for a in grads)
    return dx, dg, db, dw1.T, db1, dw2.T, db2


@pytest.mark.parametrize("act", ACTS)
def test_plain_versions_match_the_jax_reference_and_its_vjp(act):
    x, g, *params = _inputs(64, 32, 128, 0)

    @jax.jit
    def reference(ct, *a):
        out, vjp = jax.vjp(lambda *p: pallas_ffn.fused_ffn_reference(*p, activation=act), *a)
        return out, vjp(ct)

    want, (dx, dg, db, dw1, db1, dw2, db2) = reference(jnp.asarray(g), jnp.asarray(x),
                                                        *map(jnp.asarray, params))
    tx, tg, *tp = _torch(x, g, *params)
    _close("out", ffn.ffn_plain(tx, *tp, activation=act).numpy(), want)
    _close("dx", ffn.ffn_bwd_dx_plain(tx, tg, *tp[:-1], activation=act).numpy(), dx)
    got = _port_grads(ffn.ffn_bwd_full_plain(tx, tg, *tp[:-1], activation=act))
    for name, a, b in zip(NAMES, got, (dx, dg, db, dw1, db1, dw2, db2)):
        _close(name, a, b)
    # the wrappers on CPU tensors are the plain versions, dropout forms at rate 0 included
    assert torch.equal(ffn.fused_ffn(tx, *tp, activation=act),
                       ffn.ffn_plain(tx, *tp, activation=act))
    drop = ffn.fused_ffn_dropout_bwd_full(tx, tg, *tp[:-1], seed=3, activation=act)
    for name, a, b in zip(NAMES, _port_grads(drop), got):
        _close(name, a, b, 0.0)


def test_activation_gradients_at_zero_are_the_tpu_kernels():
    """relu'(0) = 0 (h > 0), leaky'(0) = 1 (h >= 0), as
    ``_apply_activation_grad``."""
    h = jnp.asarray(np.array([-1.0, 0.0, 2.0], np.float32))
    for act in ACTS:
        want = np.asarray(pallas_ffn._apply_activation_grad(h, act))
        got = ffn.activation_grad(torch.from_numpy(np.asarray(h)), act).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        want = np.asarray(pallas_ffn._apply_activation(h, act))
        np.testing.assert_allclose(ffn.activation(torch.from_numpy(np.asarray(h)), act).numpy(),
                                   want, rtol=1e-6, atol=1e-7)


def test_interpret_mode_bwd_full_on_silu():
    x, g, *params = _inputs(128, 128, 512, 1)
    want = pallas_ffn.fused_ffn_bwd_full(*map(jnp.asarray, (x, g, *params[:-1])),
                                         activation="silu", mxu_dtype_name="float32",
                                         interpret=True)
    tx, tg, *tp = _torch(x, g, *params)
    got = _port_grads(ffn.ffn_bwd_full_plain(tx, tg, *tp[:-1], activation="silu"))
    for name, a, b in zip(NAMES, got, want):
        _close(name, a, b)


def test_interpret_mode_dropout_on_leaky(jax_masks):  # noqa: F811
    """The JAX dropout kernel bodies on leaky with the TPU generator patched
    out (``jax_masks``), against the plain dropout forms under the same masks."""
    tokens, C, hidden, rate_act, rate_out = 256, 128, 512, 0.1, 0.2
    x, g, *params = _inputs(tokens, C, hidden, 2)
    kw = dict(rate_act=rate_act, rate_out=rate_out, mxu_dtype_name="float32",
              activation="leaky")
    with pltpu.force_tpu_interpret_mode():
        want = pallas_ffn.fused_ffn_dropout(jnp.asarray(x), jax_masks, *params, **kw)
        want_grads = pallas_ffn.fused_ffn_dropout_bwd_full(jnp.asarray(x), jnp.asarray(g),
                                                           jax_masks, *params[:-1], **kw)
    tm = pallas_ffn.pick_token_tile(tokens, hidden, max_bytes=pallas_ffn.FULL_BWD_TILE_BYTES)
    rows = np.arange(tokens)[:, None]
    m1 = hash_mask(rows // tm, 0, rows % tm, np.arange(hidden)[None], rate_act)
    m2 = hash_mask(rows // tm, 1, rows % tm, np.arange(C)[None], rate_out)
    masks = (torch.from_numpy(m1), torch.from_numpy(m2))
    tx, tg, *tp = _torch(x, g, *params)
    got = ffn.ffn_dropout_plain(tx, *tp, 1e-5, rate_act, rate_out, masks=masks,
                                activation="leaky")
    _close("out", got.numpy(), want)
    grads = ffn.ffn_dropout_bwd_full_plain(tx, tg, *tp[:-1], 1e-5, rate_act, rate_out,
                                           masks=masks, activation="leaky")
    for name, a, b in zip(NAMES, _port_grads(grads), want_grads):
        _close(name, a, b)


def test_every_wrapper_refuses_another_activation():
    x, g, *params = _torch(*_inputs(8, 32, 64, 3))
    calls = (lambda a: ffn.fused_ffn(x, *params, activation=a),
             lambda a: ffn.fused_ffn_dropout(x, *params, activation=a),
             lambda a: ffn.fused_ffn_bwd_dx(x, g, *params[:-1], activation=a),
             lambda a: ffn.fused_ffn_bwd_full(x, g, *params[:-1], activation=a),
             lambda a: ffn.fused_ffn_dropout_bwd_full(x, g, *params[:-1], activation=a))
    for call in calls:
        with pytest.raises(ValueError, match="activation"):
            call("tanh")
