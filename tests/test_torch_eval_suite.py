"""The port's ``ForecastEvalSuite`` (``prediff_torch/evaluation/suite.py``)
against the JAX package's on the same seeded ensembles, on the CPU: with and
without a cheap FVD feature function shared by two suites, a ragged final
batch, merge equal to one global suite, ``state_tree`` loaded across the two
packages both ways, and the refusal of a multi-rank reduce.

Counts must be exactly equal.  MSE, MAE and CRPS are held at 1e-6 relative
(SSIM 1e-5) to the JAX suite run in float64 (``jax.enable_x64``), and to the
f32 JAX suite at that bar plus its own distance from the float64 one (XLA's
f32 means on the CPU land up to a few 1e-6 from the exact value); FVD within
1e-5 of the scale of its terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.evaluation import ForecastEvalSuite as JaxSuite
from prediff_tpu.evaluation import FrechetVideoDistance as JaxFVD
from prediff_torch.datasets.synthetic import synthetic_batch_iterator
from prediff_torch.evaluation import ForecastEvalSuite, FrechetVideoDistance

M, B, T, H, W = 3, 3, 6, 16, 16
THRESHOLDS = (16, 74, 133, 160)
REL = {"mse": 1e-6, "mae": 1e-6, "crps": 1e-6, "ssim": 1e-5}


@pytest.fixture(scope="module")
def data():
    """A target of synthetic VIL windows and an ensemble of forecast-like
    members (shifted, scaled, perturbed copies), float32 numpy."""
    target = next(synthetic_batch_iterator(batch_size=B, seq_len=T, H=H, W=W, seed=11))
    rs = np.random.RandomState(11)
    preds = np.stack([np.clip((0.8 + 0.1 * m) * np.roll(target, m, axis=2)
                              + 0.05 * rs.randn(*target.shape), 0, 1) for m in range(M)])
    return preds.astype(np.float32), target.astype(np.float32)


def _feat_torch(videos):
    return videos.reshape(videos.shape[0], videos.shape[1], -1).mean(-1)


def _feat_jax(videos):
    return videos.reshape(videos.shape[0], videos.shape[1], -1).mean(-1)


def _suites(fvd: bool, mode: str = "0"):
    kw = dict(layout="NTHWC", metrics_mode=mode, seq_len=T, threshold_list=THRESHOLDS)
    fkw = dict(num_features=12, auto_t=True, reset_real_features=False)
    port = ForecastEvalSuite(fvd=FrechetVideoDistance(feature_fn=_feat_torch, **fkw)
                             if fvd else None, **kw)
    jax_ = JaxSuite(fvd=JaxFVD(feature_fn=_feat_jax, **fkw) if fvd else None, **kw)
    return port, jax_


def _feed(suite, batches, to):
    for preds, target in batches:
        suite.update(to(preds), to(target))


def _jax_pair(batches, fvd, mode="0"):
    """The JAX suite over ``batches`` in f32 and in float64."""
    _, j32 = _suites(fvd, mode)
    _feed(j32, batches, jnp.asarray)
    with jax.enable_x64(True):
        _, j64 = _suites(fvd, mode)
        _feed(j64, [(p.astype(np.float64), t.astype(np.float64)) for p, t in batches],
              jnp.asarray)
    return j32, j64


def _check(got_suite, j32, j64):
    """Counts equal; every key and value of ``compute`` at the bars."""
    for name in ("hits", "misses", "fas"):
        np.testing.assert_array_equal(getattr(got_suite.score.state, name).numpy(),
                                      np.asarray(getattr(j32.score.state, name)))
    got, w32, w64 = got_suite.compute("test"), j32.compute("test"), j64.compute("test")
    assert set(got) == set(w32)
    for k, g in got.items():
        assert isinstance(g, float), k
        metric = k.split("_")[1]
        if metric in REL:
            assert abs(g - w64[k]) <= REL[metric] * abs(w64[k]), (k, g, w64[k])
            assert abs(g - w32[k]) <= REL[metric] * abs(w32[k]) + abs(w32[k] - w64[k]), k
        elif metric == "fvd":
            (m_r, c_r), (m_f, c_f) = j32.fvd.real.mean_cov(), j32.fvd.fake.mean_cov()
            scale = np.trace(c_r) + np.trace(c_f) + np.sum((m_r - m_f) ** 2)
            assert abs(g - w32[k]) <= 1e-5 * scale, (g, w32[k], scale)
        else:   # skill scores: from equal counts
            assert g == pytest.approx(w32[k], rel=1e-6, abs=0), k
    return got


@pytest.mark.parametrize("fvd,mode", [(False, "0"), (True, "0"), (True, "1")])
def test_suite_against_jax(data, fvd, mode):
    preds, target = data
    port, _ = _suites(fvd, mode)
    _feed(port, [(preds, target)], torch.from_numpy)
    got = _check(port, *_jax_pair([(preds, target)], fvd, mode))
    assert got["test_loss_epoch"] == -got["test_csi_avg_epoch"]
    assert ("test_fvd_epoch" in got) == fvd and "test_crps_epoch" in got


def test_shared_feature_fn_and_single_member(data):
    """Two suites on one extractor (aligned and unaligned, as the CLI builds
    them) count what they saw apart; one member leaves CRPS out."""
    preds, target = data
    fkw = dict(num_features=12, auto_t=True, reset_real_features=False)
    a = ForecastEvalSuite(seq_len=T, fvd=FrechetVideoDistance(feature_fn=_feat_torch, **fkw))
    b = ForecastEvalSuite(seq_len=T, fvd=FrechetVideoDistance(feature_fn=a.fvd.feature_fn,
                                                              **fkw))
    a.update(torch.from_numpy(preds), torch.from_numpy(target))
    b.update(torch.from_numpy(preds[:1]), torch.from_numpy(target))
    assert int(a.fvd.fake.num_samples) == M * B and int(b.fvd.fake.num_samples) == B
    assert int(a.fvd.real.num_samples) == int(b.fvd.real.num_samples) == B
    assert "test_crps_epoch" in a.compute("test") and "test_crps_epoch" not in b.compute("test")


def test_ragged_final_batch(data):
    """A batch of 2 then a ragged batch of 1: the same as the JAX suite fed
    the same; MSE, MAE and CRPS equal to one update with all 3 (element-count
    weights; SSIM infers its data range per update, so it is not)."""
    preds, target = data
    batches = [(preds[:, :2], target[:2]), (preds[:, 2:], target[2:])]
    port, _ = _suites(False)
    _feed(port, batches, torch.from_numpy)
    _check(port, *_jax_pair(batches, False))
    flat, _ = _suites(False)
    _feed(flat, [(preds, target)], torch.from_numpy)
    got, want = port.compute("test"), flat.compute("test")
    for k in ("test_mse_epoch", "test_mae_epoch", "test_crps_epoch"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_merge_equals_global(data):
    """Three shards, one batch element each, merged: one suite fed the same
    updates (FVD within 1e-3: its matrix square roots amplify the f32 sums'
    order)."""
    preds, target = data
    shards = [_suites(True)[0] for _ in range(B)]
    for i, s in enumerate(shards):
        s.update(torch.from_numpy(preds[:, i:i + 1]), torch.from_numpy(target[i:i + 1]))
    merged = shards[0].merge(shards[1]).merge(shards[2])
    whole, _ = _suites(True)
    for i in range(B):
        whole.update(torch.from_numpy(preds[:, i:i + 1]), torch.from_numpy(target[i:i + 1]))
    for name in ("hits", "misses", "fas"):
        assert torch.equal(getattr(merged.score.state, name), getattr(whole.score.state, name))
    got, want = merged.compute("test"), whole.compute("test")
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3 if k == "test_fvd_epoch" else 1e-5), k


def test_state_tree_across_packages(data):
    """A tree written by the port loads in the JAX suite and the other way
    round: the same keys, dtypes and shapes, and the loading suite's compute
    equals the writer's."""
    preds, target = data
    port, jax_ = _suites(True)
    port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _feed(jax_, [(preds, target)], jnp.asarray)
    tp, tj = port.state_tree(), jax_.state_tree()
    assert set(tp) == set(tj)
    for k in tj:
        assert isinstance(tp[k], np.ndarray), k
        assert tp[k].dtype == tj[k].dtype and tp[k].shape == tj[k].shape, k
    into_jax, into_port = _suites(True)[1], _suites(True)[0]
    into_jax.load_state_tree(tp)
    into_port.load_state_tree(tj)
    for loaded, writer in ((into_jax, port), (into_port, jax_)):
        got, want = loaded.compute("test"), writer.compute("test")
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
    # a loaded port suite keeps accumulating
    into_port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert int(into_port.fvd.fake.num_samples) == 2 * M * B


def test_cross_process_reduce(data, monkeypatch):
    """One process: nothing to do.  Several ranks of torch.distributed:
    refused, naming the ROADMAP item."""
    port, _ = _suites(False)
    assert port.cross_process_reduce() is port
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 1)
    assert port.cross_process_reduce() is port
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        port.cross_process_reduce()


def test_rejects_unbatched_preds(data):
    preds, target = data
    with pytest.raises(ValueError):
        _suites(False)[0].update(torch.from_numpy(preds[0]), torch.from_numpy(target))
