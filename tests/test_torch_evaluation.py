"""The port's evaluation metrics (``prediff_torch/evaluation/metrics.py``,
``skill_scores.py``) against the JAX package's on the same seeded numpy
inputs, on the CPU.  Counts must be exactly equal; floats within 1e-6
relative (SSIM 1e-5).  A float is held to the JAX function evaluated in
float64 on the same inputs (``jax.enable_x64``) at that bar, and to its f32
value at the bar plus the f32 value's own distance from the float64 one:
XLA's f32 reductions on the CPU land up to ~3.5e-6 from the exact mean of
~5 k elements, torch's within ~1e-7.  The SSIM inputs are forecast-like
(synthetic VIL fields and a perturbed copy): on two independent noise fields
SSIM is near 0 and its relative error says nothing about the arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.evaluation import metrics as jm
from prediff_tpu.evaluation import skill_scores as js
from prediff_torch.datasets.synthetic import synthetic_batch_iterator
from prediff_torch.evaluation import metrics as tm
from prediff_torch.evaluation import skill_scores as ts

REL = 1e-6
REL_SSIM = 1e-5
THRESHOLDS = (16, 74, 133, 160, 181, 219)


def _pair(seed, B=2, T=4, H=24, W=28):
    """A target of synthetic VIL fields in [0, 1] and a forecast-like
    prediction: the target shifted, scaled and perturbed, clipped to [0, 1]."""
    target = next(synthetic_batch_iterator(batch_size=B, seq_len=T, H=H, W=W, seed=seed))
    rs = np.random.RandomState(seed)
    pred = np.clip(0.9 * np.roll(target, 1, axis=3) + 0.05 * rs.randn(*target.shape), 0, 1)
    return pred.astype(np.float32), target.astype(np.float32)


def _close(got, want, rel):
    np.testing.assert_allclose(float(got), float(want), rtol=rel, atol=0)


def _close_jax(got, fn, arrays, rel, **kw):
    """``got`` within ``rel`` of ``fn`` (a JAX function) on ``arrays`` in
    float64, and of its f32 value up to that value's own rounding."""
    want32 = float(fn(*map(jnp.asarray, arrays), **kw))
    with jax.enable_x64(True):
        want64 = float(fn(*(jnp.asarray(a.astype(np.float64)) for a in arrays), **kw))
    got = float(got)
    assert abs(got - want64) <= rel * abs(want64), (got, want64)
    assert abs(got - want32) <= rel * abs(want32) + abs(want32 - want64), (got, want32, want64)


@pytest.mark.parametrize("seed", [0, 1])
def test_mse_mae_pearson(seed):
    p, t = _pair(seed)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    _close_jax(tm.mse(pt, tt), jm.mse, (p, t), REL)
    _close_jax(tm.mae(pt, tt), jm.mae, (p, t), REL)
    _close_jax(tm.pearson_corr(pt, tt), jm.pearson_corr, (p, t), REL)


@pytest.mark.parametrize("kw", [dict(), dict(gaussian_kernel=False), dict(data_range=1.0),
                                dict(kernel_size=7, sigma=1.0)])
def test_ssim(kw):
    p, t = _pair(3, B=3, T=2, H=32, W=30)
    # (B*T, H, W, C) frames, as the suite passes them
    p, t = p.reshape((-1,) + p.shape[2:]), t.reshape((-1,) + t.shape[2:])
    got = tm.ssim(torch.from_numpy(p), torch.from_numpy(t), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    _close_jax(got, jm.ssim, (p, t), REL_SSIM, **kw)
    assert 0.2 < float(got) < 1.0


@pytest.mark.parametrize("M,fair", [(4, True), (4, False), (2, True), (1, True)])
def test_crps_ensemble(M, fair):
    rs = np.random.RandomState(M)
    _, t = _pair(4, B=2, T=3, H=8, W=8)
    ens = np.clip(t[None] + 0.1 * rs.randn(M, *t.shape), 0, 1).astype(np.float32)
    got = tm.crps_ensemble(torch.from_numpy(ens), torch.from_numpy(t), fair=fair)
    _close_jax(got, jm.crps_ensemble, (ens, t), REL, fair=fair)


def test_mean_metric_ragged_batches():
    """Batch means weighted by element counts over ragged batches, and raw
    arrays without a weight: the same totals as the JAX MeanMetric; merge
    of two halves equals one metric over all."""
    rs = np.random.RandomState(5)
    batches = [rs.rand(n, 6).astype(np.float32) for n in (4, 4, 3, 1)]
    mj, mt = jm.MeanMetric(), tm.MeanMetric()
    halves = [tm.MeanMetric(), tm.MeanMetric()]
    for i, b in enumerate(batches):
        mj.update(jnp.mean(jnp.asarray(b)), weight=b.size)
        mt.update(torch.from_numpy(b).mean(), weight=b.size)
        halves[i % 2].update(torch.from_numpy(b).mean(), weight=b.size)
    mj.update(jnp.asarray(batches[0]))
    mt.update(torch.from_numpy(batches[0]))
    halves[0].update(torch.from_numpy(batches[0]))
    assert mt.count == mj.count
    _close(mt.total, mj.total, REL)
    _close(mt.compute(), mj.compute(), REL)
    halves[0].merge(halves[1])
    _close(halves[0].compute(), mt.compute(), REL)
    flat = np.concatenate([b.ravel() for b in batches] + [batches[0].ravel()])
    _close(mt.compute(), flat.astype(np.float64).mean(), REL)


@pytest.mark.parametrize("reduce_dims", [(0, 1, 2, 3, 4), (0, 2, 3, 4)])
def test_threshold_counts_with_nans(reduce_dims):
    p, t = _pair(6)
    p, t = p * 255.0, t * 255.0
    rs = np.random.RandomState(6)
    p[rs.rand(*p.shape) < 0.05] = np.nan
    t[rs.rand(*t.shape) < 0.05] = np.nan
    want = js.threshold_counts(jnp.asarray(p), jnp.asarray(t), THRESHOLDS, reduce_dims)
    got = ts.threshold_counts(torch.from_numpy(p), torch.from_numpy(t), THRESHOLDS, reduce_dims)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[0].sum()) > 0


def _compare_scores(got, want):
    assert set(got) == set(want)
    for th in want:
        assert set(got[th]) == set(want[th])
        for metric, w in want[th].items():
            g = got[th][metric]
            assert type(g) is type(w)
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=REL, atol=0)


@pytest.mark.parametrize("mode,pool", [("0", "sevir"), ("1", "sevir"), ("2", "sevir"),
                                       ("0", "sevir_pool4"), ("2", "sevir_pool4")])
def test_skill_score_modes(mode, pool):
    """Two updates (one a ragged batch), counts exactly equal, every score
    of ``compute`` within 1e-6 relative; the bias is the reference's
    formula as the JAX package computes it."""
    kw = dict(layout="NTHWC", mode=mode, seq_len=4, preprocess_type=pool)
    sj, st = js.SEVIRSkillScore(**kw), ts.SEVIRSkillScore(**kw)
    for seed, B in ((7, 2), (8, 1)):
        p, t = _pair(seed, B=B, H=26, W=30)
        sj.update(jnp.asarray(p), jnp.asarray(t))
        st.update(torch.from_numpy(p), torch.from_numpy(t))
    for name in ("hits", "misses", "fas"):
        g, w = getattr(st.state, name), np.asarray(getattr(sj.state, name))
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    _compare_scores(st.compute(), sj.compute())


def test_skill_score_merge_equals_global():
    kw = dict(layout="NTHWC", mode="1", seq_len=4)
    shards = [ts.SEVIRSkillScore(**kw) for _ in range(3)]
    whole, whole_j = ts.SEVIRSkillScore(**kw), js.SEVIRSkillScore(**kw)
    for i, seed in enumerate((9, 10, 11)):
        p, t = _pair(seed)
        shards[i].update(torch.from_numpy(p), torch.from_numpy(t))
        whole.update(torch.from_numpy(p), torch.from_numpy(t))
        whole_j.update(jnp.asarray(p), jnp.asarray(t))
    merged = shards[0].state.merge(shards[1].state).merge(shards[2].state)
    for name in ("hits", "misses", "fas"):
        np.testing.assert_array_equal(getattr(merged, name).numpy(),
                                      getattr(whole.state, name).numpy())
        np.testing.assert_array_equal(getattr(merged, name).numpy(),
                                      np.asarray(getattr(whole_j.state, name)))
    _compare_scores(whole.compute(merged), whole_j.compute())


def test_skill_score_refusals():
    with pytest.raises(ValueError):
        ts.SEVIRSkillScore(mode="3")
    with pytest.raises(ValueError):
        ts.SEVIRSkillScore(mode="1")          # needs seq_len
    with pytest.raises(ValueError):
        ts.SEVIRSkillScore(preprocess_type="other")
