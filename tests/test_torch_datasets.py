"""The port's data pipeline (``prediff_torch/datasets``) against the JAX
package's on the CPU: the layout helpers and ``rasterize_lightning``, the
synthetic SEVIR-LR writer (same seed, equal files and catalog), the loader's
windows, sharding and random mode, ``SEVIRDataModule``'s train (aug "2"),
val and test batches, augmentation, ``prefetch_to_device`` on the CPU, and
both packages' imports with h5py and pandas blocked.  Arrays must be equal.
"""
import os
import subprocess
import sys
import threading

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import prediff_tpu.datasets as jd
import prediff_tpu.datasets.sevir as js
import prediff_torch.datasets as td
import prediff_torch.datasets.sevir as ts
from prediff_tpu.datasets.augmentation import fixed_angle_rotation as jax_rotation
from prediff_torch.datasets.augmentation import fixed_angle_rotation
from prediff_torch.datasets.prefetch import prefetch_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same synthetic dataset written by each package."""
    base = tmp_path_factory.mktemp("sevirlr")
    kw = dict(num_events=8, H=32, W=32, T=25, seed=4)
    return (td.make_synthetic_sevir_lr(str(base / "port"), **kw),
            jd.make_synthetic_sevir_lr(str(base / "jax"), **kw))


def _loader_kw(root, **kw):
    return dict(data_types=["vil"], seq_len=13, raw_seq_len=25, stride=6, layout="NTHWC",
                sevir_catalog=f"{root}/CATALOG.csv", sevir_data_dir=f"{root}/data", **kw)


def test_layout_helpers():
    x = np.random.RandomState(0).rand(2, 8, 6, 25)  # NHWT
    for layout in ("NTHWC", "NTHW", "TNHW", "NHWT"):
        np.testing.assert_array_equal(ts.change_layout(x, "NHWT", layout),
                                      js.change_layout(x, "NHWT", layout))
    y = np.arange(2 * 7 * 9 * 6).reshape(2, 7, 9, 6).astype(np.float32)
    for factors in ((2, 3, 3), (1, 2, 4), (3, 1, 1)):
        np.testing.assert_array_equal(ts.max_pool_downsample(y, factors, "NHWT"),
                                      js.max_pool_downsample(y, factors, "NHWT"))


@pytest.mark.parametrize("n", [0, 1, 300])
def test_rasterize_lightning(n):
    rs = np.random.RandomState(n)
    strikes = np.stack([rs.uniform(-9000, 9000, n), rs.uniform(0, 1, n), rs.uniform(0, 1, n),
                        rs.randint(-5, 53, n).astype(float),
                        rs.randint(-5, 53, n).astype(float)], axis=1)
    got = ts.rasterize_lightning(strikes)
    assert got.dtype == np.int16 and got.shape == (48, 48, 49)
    np.testing.assert_array_equal(got, js.rasterize_lightning(strikes))
    assert got.sum() <= n


def test_synthetic_writer_equal(roots):
    port, jax_ = roots
    with open(f"{port}/CATALOG.csv") as a, open(f"{jax_}/CATALOG.csv") as b:
        assert a.read() == b.read()
    names = pd.read_csv(f"{port}/CATALOG.csv").file_name.unique()
    assert len(names) == 2
    for name in names:
        with h5py.File(f"{port}/data/{name}", "r") as a, h5py.File(f"{jax_}/data/{name}", "r") as b:
            assert a["vil"].dtype == np.uint8 and a["vil"].shape == (4, 32, 32, 25)
            np.testing.assert_array_equal(a["vil"][:], b["vil"][:])
    np.testing.assert_array_equal(next(td.synthetic_batch_iterator(2, 13, 32, 32, seed=5)),
                                  next(jd.synthetic_batch_iterator(2, 13, 32, 32, seed=5)))


def test_loader_windows_and_preprocess(roots):
    root = roots[0]
    for rescale in ("01", "sevir"):
        p = ts.SEVIRDataLoader(rescale_method=rescale, **_loader_kw(root))
        j = js.SEVIRDataLoader(rescale_method=rescale, **_loader_kw(root))
        assert (p.num_seq_per_event, p.total_num_event, p.total_num_seq, len(p)) == (
            j.num_seq_per_event, j.total_num_event, j.total_num_seq, len(j)) == (3, 8, 24, 24)
        for i in (0, 1, 5, 23):
            a, b = p._idx_sample(i)["vil"], j._idx_sample(i)["vil"]
            assert a.shape == (1, 13, 32, 32, 1) and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        p.close()
        j.close()


@pytest.mark.parametrize("num_shard,split_mode", [(4, "uneven"), (3, "ceil"), (3, "floor")])
def test_loader_sharding(roots, num_shard, split_mode):
    """Each rank's events and batches (sequent, batch_size 2) equal the JAX
    loader's for the same rank."""
    root = roots[0]
    for rank in range(num_shard):
        kw = _loader_kw(root, num_shard=num_shard, rank=rank, split_mode=split_mode,
                        batch_size=2)
        p, j = ts.SEVIRDataLoader(**kw), js.SEVIRDataLoader(**kw)
        assert (p.start_event_idx, p.end_event_idx) == (j.start_event_idx, j.end_event_idx)
        got, want = list(p), list(j)
        assert len(got) == len(want) == len(p)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["vil"], b["vil"])
        p.close()
        j.close()


def test_loader_random_mode_and_shuffle(roots):
    root = roots[0]
    for kw in (dict(sample_mode="random", shuffle_seed=3), dict(shuffle=True, shuffle_seed=5)):
        p = ts.SEVIRDataLoader(**_loader_kw(root, **kw))
        j = js.SEVIRDataLoader(**_loader_kw(root, **kw))
        got, want = list(p), list(j)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["vil"], b["vil"])
        p.close()
        j.close()


def test_datamodule_batches(roots):
    """train (aug "2", shuffled), val and test batches for the same seed."""
    root = roots[0]
    kw = dict(seq_len=13, stride=6, layout="NTHWC", sevir_dir=root, batch_size=2,
              val_ratio=0.25, dataset_name="sevirlr", aug_mode="2", seed=7)
    p, j = ts.SEVIRDataModule(**kw), js.SEVIRDataModule(**kw)
    p.prepare_data()
    p.setup()
    j.setup()
    assert (p.num_train_samples, p.num_val_samples, p.num_test_samples) == (
        j.num_train_samples, j.num_val_samples, j.num_test_samples) == (9, 3, 12)
    for name, args in (("train_batches", (0,)), ("train_batches", (1,)), ("val_batches", ()),
                       ("test_batches", ())):
        got = list(getattr(p, name)(*args))
        want = list(getattr(j, name)(*args))
        assert len(got) == len(want) > 0, name
        for a, b in zip(got, want):
            assert a.shape[1:] == (13, 32, 32, 1)
            np.testing.assert_array_equal(a, b)
    ds = ts.SEVIRDataset(p._trainval, seed=1, aug_mode="2")
    assert isinstance(ds, torch.utils.data.Dataset) and len(ds) == 12
    np.testing.assert_array_equal(ds[4], js.SEVIRDataset(j._trainval, seed=1, aug_mode="2")[4])


def test_datamodule_refusals(tmp_path):
    with pytest.raises(ValueError, match="sevir_dir"):
        ts.SEVIRDataModule(sevir_dir=None)
    dm = ts.SEVIRDataModule(sevir_dir=str(tmp_path / "missing"))
    with pytest.raises(FileNotFoundError, match="CATALOG.csv"):
        dm.prepare_data()


@pytest.mark.parametrize("mode", ["0", "1", "2"])
def test_augmentation(mode):
    x = np.random.RandomState(1).rand(5, 16, 16, 1).astype(np.float32)
    rp, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(6):
        a = td.augment_seq(x, "THWC", mode, rp)
        b = jd.augment_seq(x, "THWC", mode, rj)
        assert a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
    for angle in (90, -45, 30, 270):
        np.testing.assert_array_equal(fixed_angle_rotation(x, angle, 1, 2),
                                      jax_rotation(x, angle, 1, 2))


def test_prefetch_cpu_order_and_transform():
    batches = [(np.full((2, 3), i, np.float32), {"y": np.arange(i + 1)}) for i in range(7)]
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu",
                                  transform=lambda b: (b[0] * 2, b[1])))
    assert len(got) == 7
    for i, (x, d) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), 2.0 * i))
        assert torch.equal(d["y"], torch.arange(i + 1))


def test_prefetch_cpu_error_reraised():
    def source():
        yield np.zeros(2)
        raise OSError("bad HDF5 read")

    it = prefetch_to_device(source(), device="cpu")
    assert torch.equal(next(it), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(OSError, match="bad HDF5 read"):
        next(it)


def _producers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_cpu_stops_on_close():
    """Closed mid-stream (a max-steps break), the producer stops within its
    put timeout instead of blocking on a full queue forever."""
    before = set(_producers())
    it = prefetch_to_device((np.zeros(4) for _ in range(10**6)), size=2, device="cpu")
    next(it)
    (producer,) = set(_producers()) - before
    it.close()
    producer.join(timeout=5)
    assert not producer.is_alive()


def test_prefetch_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([np.zeros(1)])))


def test_imports_without_h5py_and_pandas():
    """Both packages import with h5py and pandas blocked; what needs them
    says so when called."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['pandas'] = None\n"
        "import prediff_torch.datasets as d, prediff_torch.evaluation\n"
        "import prediff_torch.datasets.latents\n"
        "for call in (lambda: d.make_synthetic_sevir_lr('x'), lambda: d.SEVIRDataLoader()):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print('refused:', e)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("refused:") == 2 and out.stdout.strip().endswith("ok")
