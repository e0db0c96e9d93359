"""Evaluation and data on the card: ``ForecastEvalSuite`` on CUDA tensors
against the same suite on the CPU, and ``prefetch_to_device``'s batches
through pinned memory on a side stream.  Every test needs a CUDA device and
skips without one.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_eval_cuda.py
"""
import numpy as np
import pytest
import torch

from prediff_torch.datasets import augment_seq, prefetch_to_device, synthetic_batch_iterator
from prediff_torch.datasets import prefetch as prefetch_mod
from prediff_torch.evaluation import (ForecastEvalSuite, FrechetVideoDistance, i3d_feature_fn,
                                      seeded_i3d)

pytestmark = pytest.mark.cuda

M, B, T, H, W = 2, 2, 6, 64, 64


@pytest.fixture
def dev():
    """The card; decided per test, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _ensemble(seed):
    target = next(synthetic_batch_iterator(batch_size=B, seq_len=T, H=H, W=W, seed=seed))
    rs = np.random.RandomState(seed)
    preds = np.stack([np.clip(0.9 * target + 0.05 * rs.randn(*target.shape), 0, 1)
                      for _ in range(M)])
    return torch.from_numpy(preds.astype(np.float32)), torch.from_numpy(target)


def test_suite_card_vs_cpu(dev):
    """The same ensemble scored on the card and on the CPU (one I3D at 64x64
    with seeded weights shared by both suites): counts equal, MSE / MAE /
    CRPS within 1e-6 relative, SSIM 1e-5, FVD 1e-3, every value finite."""
    feature_fn = i3d_feature_fn(seeded_i3d(num_classes=16, seed=0), target_resolution=64)
    suites = {d: ForecastEvalSuite(seq_len=T, fvd=FrechetVideoDistance(
        feature_fn=feature_fn, num_features=16, auto_t=True, reset_real_features=False))
        for d in ("cuda", "cpu")}
    for seed in (1, 2):
        preds, target = _ensemble(seed)
        suites["cuda"].update(preds.to(dev), target.to(dev))
        suites["cpu"].update(preds, target)
    assert suites["cuda"].score.state.hits.device.type == "cuda"
    for name in ("hits", "misses", "fas"):
        assert torch.equal(getattr(suites["cuda"].score.state, name).cpu(),
                           getattr(suites["cpu"].score.state, name))
    got, want = suites["cuda"].compute("test"), suites["cpu"].compute("test")
    assert set(got) == set(want)
    for k, v in got.items():
        assert np.isfinite(v), k
        rel = {"ssim": 1e-5, "fvd": 1e-3}.get(k.split("_")[1], 1e-6)
        assert v == pytest.approx(want[k], rel=rel, abs=1e-12), k


def test_prefetch_pinned_side_stream(dev, monkeypatch):
    """Batches (augmented on the host by the producer) arrive on the card,
    bit-equal to the host batches, staged through pinned memory."""
    staged = []

    def spy(t):
        p = t.pin_memory()
        staged.append(p.is_pinned())
        return p

    monkeypatch.setattr(prefetch_mod, "pinned", spy)
    host = list(synthetic_batch_iterator(batch_size=2, seq_len=5, H=32, W=32, seed=3,
                                         num_batches=4))

    def transform(b):
        return np.stack([augment_seq(s, "THWC", "2", np.random.default_rng(i))
                         for i, s in enumerate(b)])

    got = list(prefetch_to_device(iter(host), size=2, device=dev, transform=transform))
    assert len(got) == 4 and staged == [True] * 4
    for g, h in zip(got, host):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), torch.from_numpy(transform(h)))
