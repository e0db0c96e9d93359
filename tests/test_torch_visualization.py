"""The port's SEVIR visualization and ``MetricLogger`` against the JAX
package's (CPU): the VIL colormap and levels, the hit / miss / false-alarm
mask, ``vis_sevir_seq``'s PNG pixel for pixel and ``save_gif``'s frames from
the same inputs (numpy and tensors), the ImportError without matplotlib;
the jsonl records (apart from ``time``), and TensorBoard / WandB asked for
with their packages blocked."""
import json
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from prediff_tpu.datasets import visualization as jvis
from prediff_tpu.training.loop import MetricLogger as JaxMetricLogger
from prediff_torch.datasets import visualization as tvis
from prediff_torch.training import MetricLogger


def _seq(seed, T=4, H=16, W=16):
    return np.random.RandomState(seed).rand(T, H, W, 1).astype(np.float32)


def test_colormap_levels_and_hit_miss_mask_match_jax():
    assert tvis.VIL_COLORS == jvis.VIL_COLORS and tvis.VIL_LEVELS == jvis.VIL_LEVELS
    (tc, tn), (jc, jn) = tvis.vil_cmap(), jvis.vil_cmap()
    assert np.array_equal(tc.colors, jc.colors) and tc.N == jc.N
    for f in ("get_bad", "get_under", "get_over"):
        assert getattr(tc, f)() == pytest.approx(getattr(jc, f)())
    assert np.array_equal(tn.boundaries, jn.boundaries)
    assert tvis.get_cmap("lght") == jvis.get_cmap("lght")

    class Ax:
        def imshow(self, img, **kw):
            self.img, self.kw = img, kw

    truth, pred = _seq(0) * 255, _seq(1) * 255
    got, want = Ax(), Ax()
    tvis.plot_hit_miss_fa(got, torch.from_numpy(truth), pred, 74.0)
    jvis.plot_hit_miss_fa(want, truth, pred, 74.0)
    assert np.array_equal(got.img, want.img) and set(np.unique(got.img)) <= {1, 2, 3, 4}
    assert got.kw["cmap"].colors == want.kw["cmap"].colors


def test_sequence_panel_pixels_and_gif_frames_match_jax(tmp_path):
    rows = [_seq(2), _seq(3), _seq(4, T=2)]
    labels = ["context", "target", "pred_0"]
    kw = dict(interval_real_time=10, plot_stride=1, fs=8)
    tvis.vis_sevir_seq(str(tmp_path / "port.png"), [torch.from_numpy(r) for r in rows],
                       labels, **kw)
    jvis.vis_sevir_seq(str(tmp_path / "jax.png"), rows, labels, **kw)
    got = np.asarray(Image.open(tmp_path / "port.png").convert("RGBA"))
    want = np.asarray(Image.open(tmp_path / "jax.png").convert("RGBA"))
    assert got.shape == want.shape and np.array_equal(got, want)

    tvis.save_gif(torch.from_numpy(rows[0] * 1.2 - 0.1), str(tmp_path / "port.gif"))
    jvis.save_gif(rows[0] * 1.2 - 0.1, str(tmp_path / "jax.gif"))
    frames = [[np.asarray(f.convert("L")) for f in ImageSequence.Iterator(Image.open(p))]
              for p in (tmp_path / "port.gif", tmp_path / "jax.gif")]
    assert len(frames[0]) == 4 and all(np.array_equal(a, b) for a, b in zip(*frames))


def test_panels_without_matplotlib_raise_naming_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tvis.vis_sevir_seq(str(tmp_path / "x.png"), _seq(5))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_metric_logger_records_match_jax(tmp_path):
    metrics = [(1, {"train/loss": torch.tensor(0.25), "lr": 1e-3, "name": "text"}, ""),
               (2, {"csi": np.float32(0.5), "none": None}, "valid_")]
    port, jax_ = MetricLogger(str(tmp_path / "p")), JaxMetricLogger(str(tmp_path / "j"))
    for step, m, prefix in metrics:
        port.log(step, m, prefix=prefix)
        jax_.log(step, m, prefix=prefix)
    got, want = _records(port.path), _records(jax_.path)
    assert [{k: v for k, v in r.items() if k != "time"} for r in got] == \
        [{k: v for k, v in r.items() if k != "time"} for r in want]
    assert got[1] == {"step": 2, "time": got[1]["time"], "valid_csi": 0.5}


def test_metric_logger_extras_without_their_packages_still_write_the_jsonl(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    logger = MetricLogger(str(tmp_path), use_tensorboard=True, use_wandb=True, run_name="r",
                          config={"a": 1})
    assert logger._tb is None and logger._wandb is None
    logger.log(3, {"loss": 1.5})
    assert [{k: v for k, v in r.items() if k != "time"} for r in _records(logger.path)] == \
        [{"step": 3, "loss": 1.5}]
