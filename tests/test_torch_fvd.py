"""The port's FVD (``prediff_torch/evaluation/fvd.py``) against the JAX
package's on the CPU: the Inception-I3D at ``num_classes=40`` on
(2, 9, 32, 32, 3) with the same seeded weights through the bridge (rel-L2 <=
1e-4), ``preprocess_video`` enlarging and reducing (the two libraries'
antialiased bilinear resizes), the streaming moments and the Fréchet math in
float64, and ``FrechetVideoDistance`` with ``auto_t`` on T=6, C=1 videos.

The flax leaves come from ``jax.eval_shape(model.init, ...)`` filled with
seeded numpy (BatchNorm variances positive): an un-jitted I3D init takes
about a minute on a CPU, the shapes alone and one jitted apply a few seconds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.evaluation import fvd as jf
from prediff_torch.evaluation import fvd as tf
from prediff_torch.utils.convert import flax_params_to_torch

NUM_CLASSES = 40
REL_L2 = 1e-4


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fvd_close(got: float, fvd_j, rel: float):
    """``got`` within ``rel`` of the JAX instance's FVD, relative to the
    scale of the terms it is the difference of (the two covariances' traces
    and the squared mean gap): FVD is a small difference of large terms
    where real and fake are alike, so its own relative error says little."""
    (m_r, c_r), (m_f, c_f) = fvd_j.real.mean_cov(), fvd_j.fake.mean_cov()
    scale = np.trace(c_r) + np.trace(c_f) + np.sum((m_r - m_f) ** 2)
    want = fvd_j.compute()
    assert abs(got - want) <= rel * scale, (got, want, scale)


def _fill(shapes, seed):
    """Seeded numpy leaves for a flax variable tree of ``ShapeDtypeStruct``s
    that keep the input's signal through the 20-odd layers: kernels at
    sqrt(2 / fan-in) (ReLU's gain), BatchNorm near the identity (variances in
    [0.8, 1.2], scales near 1), means and biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.01 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def i3d():
    model = jf.InceptionI3d(num_classes=NUM_CLASSES)
    x = jnp.zeros((1, 9, 32, 32, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    variables = _fill(shapes, seed=1)
    port = tf.InceptionI3d(num_classes=NUM_CLASSES)
    state = flax_params_to_torch(port, variables["params"], variables["batch_stats"])
    port.load_state_dict(state)
    return dict(model=model, variables=variables, port=port.eval(), state=state)


def test_i3d_names_and_logits(i3d):
    """Every flax leaf maps onto one port parameter by name
    (``flax_params_to_torch`` is strict), and the logits agree."""
    assert "Conv3d_1a_7x7.conv3d.weight" in i3d["state"]
    assert "Mixed_3b.b1a.bn.running_mean" in i3d["state"]
    assert "logits.conv3d.bias" in i3d["state"]
    x = (np.random.RandomState(2).rand(2, 9, 32, 32, 3) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, x: i3d["model"].apply(v, x, train=False))(
        i3d["variables"], jnp.asarray(x)))
    with torch.no_grad():
        got = i3d["port"](torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, NUM_CLASSES)
    assert _rel_l2(got, want) <= REL_L2


@pytest.mark.parametrize("shape,res", [((2, 3, 20, 24, 3), 32),     # enlarge, W > H
                                       ((1, 2, 70, 60, 1), 32),     # reduce, H > W
                                       ((1, 2, 48, 48, 3), 48)])    # same size
def test_preprocess_video(shape, res):
    v = np.random.RandomState(3).rand(*shape).astype(np.float32)
    want = np.asarray(jf.preprocess_video(jnp.asarray(v), res))
    got = tf.preprocess_video(torch.from_numpy(v), res).numpy()
    assert got.shape == want.shape == shape[:2] + (res, res, shape[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_streaming_moments_and_frechet_float64():
    """FVDState over two updates against the JAX state (f32 sums) and the
    float64 batch moments; the Fréchet distance from moments and from
    batches against the JAX functions in float64."""
    rs = np.random.RandomState(4)
    x = rs.randn(40, 8).astype(np.float32)
    st, sj = tf.FVDState.zeros(8), jf.FVDState.zeros(8)
    for part in (x[:15], x[15:]):
        st = st.update(torch.from_numpy(part))
        sj = sj.update(jnp.asarray(part))
    assert int(st.num_samples) == int(sj.num_samples) == 40
    assert st.num_samples.dtype == torch.int32
    m, c = st.mean_cov()
    mj, cj = sj.mean_cov()
    assert m.dtype == c.dtype == np.float64
    np.testing.assert_allclose(m, mj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(c, cj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c, np.cov(x.astype(np.float64), rowvar=False), rtol=1e-4,
                               atol=1e-5)
    x1 = rs.randn(64, 12)
    x2 = rs.randn(64, 12) * 1.3 + 0.4
    assert tf.frechet_distance(x1, x2) == jf.frechet_distance(x1, x2)
    m1, c1, m2, c2 = x1.mean(0), np.cov(x1, rowvar=False), x2.mean(0), np.cov(x2, rowvar=False)
    assert (tf.frechet_distance_from_moments(m1, c1, m2, c2)
            == jf.frechet_distance_from_moments(m1, c1, m2, c2))
    assert tf.frechet_distance(x1, x1.copy()) == pytest.approx(0.0, abs=1e-9)


def test_fvd_auto_t_single_channel(i3d):
    """T=6, C=1 videos: repeat-interleaved to T=12, tiled to 3 channels,
    through the I3D with the state dict (``i3d_params``) at 32x32, against
    the JAX FVD with the flax variables: features rel-L2 <= 1e-4, FVD
    within 1e-3 of the scale of its terms; T=6 without ``auto_t`` refused on both sides."""
    rs = np.random.RandomState(5)
    real = rs.rand(3, 6, 20, 20, 1).astype(np.float32)
    fake = np.clip(real + 0.2 * rs.randn(*real.shape), 0, 1).astype(np.float32)
    kw = dict(num_features=NUM_CLASSES, auto_t=True, target_resolution=32)
    ft = tf.FrechetVideoDistance(i3d_params=i3d["state"], **kw)
    fj = jf.FrechetVideoDistance(i3d_params=i3d["variables"], **kw)
    for videos, is_real in ((real, True), (fake, False)):
        ft.update(torch.from_numpy(videos), real=is_real)
        fj.update(jnp.asarray(videos), real=is_real)
    for name in ("real", "fake"):
        st, sj = getattr(ft, name), getattr(fj, name)
        assert int(st.num_samples) == int(sj.num_samples) == 3
        assert _rel_l2(st.features_sum.numpy(), np.asarray(sj.features_sum)) <= REL_L2
    # the features themselves, from the repeat-interleaved, tiled videos
    tiled = np.repeat(np.repeat(fake, 2, axis=1), 3, axis=-1)
    got = ft.feature_fn(torch.from_numpy(tiled)).numpy()
    want = np.asarray(fj.feature_fn(jnp.asarray(tiled)))
    assert _rel_l2(got, want) <= REL_L2
    _fvd_close(ft.compute(), fj, 1e-3)
    ft.reset()
    assert int(ft.real.num_samples) == int(ft.fake.num_samples) == 0
    with pytest.raises(ValueError):
        tf.FrechetVideoDistance(feature_fn=lambda v: v, num_features=1).update(
            torch.zeros(1, 6, 4, 4, 3), real=True)
    with pytest.raises(ValueError):
        tf.FrechetVideoDistance(num_features=NUM_CLASSES)      # no extractor


def test_fvd_shared_feature_fn_normalize():
    """A cheap feature function shared by two instances (the suites' way),
    ``normalize`` on 0-255 videos, ``reset_real_features=False``: the same
    moments and FVD (to 1e-5 of its terms' scale) as the JAX instances."""
    def feat_t(v):
        return v.reshape(v.shape[0], v.shape[1], -1).mean(-1)

    def feat_j(v):
        return v.reshape(v.shape[0], v.shape[1], -1).mean(-1)

    rs = np.random.RandomState(6)
    real = (255 * rs.rand(16, 10, 4, 4, 1)).astype(np.float32)
    fake = np.clip(real + 30 * rs.randn(*real.shape), 0, 255).astype(np.float32)
    kw = dict(num_features=10, normalize=True, reset_real_features=False)
    pair = [tf.FrechetVideoDistance(feature_fn=feat_t, **kw),
            tf.FrechetVideoDistance(feature_fn=feat_t, **kw)]
    fj = jf.FrechetVideoDistance(feature_fn=feat_j, **kw)
    for f in pair:
        f.update(torch.from_numpy(real), real=True)
        f.update(torch.from_numpy(fake), real=False)
    fj.update(jnp.asarray(real), real=True)
    fj.update(jnp.asarray(fake), real=False)
    assert pair[0].compute() == pair[1].compute()
    _fvd_close(pair[0].compute(), fj, 1e-5)
    pair[0].reset()
    assert int(pair[0].real.num_samples) == 16 and int(pair[0].fake.num_samples) == 0
