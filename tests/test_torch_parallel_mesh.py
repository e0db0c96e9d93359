"""``prediff_torch/parallel`` against the JAX package's ``parallel/mesh.py``
on the CPU, and the pieces that use it on two gloo ranks: the mesh
arithmetic, ``init_distributed``'s no-cluster and unreachable-cluster cases,
the collectives, ``prefetch_to_device(sharding=)``,
``ForecastEvalSuite.cross_process_reduce`` and ``train_sevirlr_prediff --test
--multihost``.

The two ranks are processes of ``tests/torch_parallel_worker.py``, started
once for the file, with JAX and the JAX package blocked in them (the port
imports neither).  ``cross_process_reduce`` must give, on both ranks, the
``merge`` of the two ranks' suites in one process bit for bit; the program's
metrics file must be, bit for bit, the merge of the one-process runs of the
two shards of the test events (each rank runs its shard alone first).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch_parallel_worker import CLUSTER_ENV, free_port, run_ranks

from prediff_tpu.parallel import mesh as jax_mesh
from prediff_torch.datasets import make_synthetic_sevir_lr
from prediff_torch.evaluation import ForecastEvalSuite, FrechetVideoDistance
from prediff_torch.parallel import mesh as torch_mesh


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of the ``mesh`` task: 8 synthetic events at 32x32,
    the test split's four shared two a rank."""
    out = tmp_path_factory.mktemp("mesh")
    make_synthetic_sevir_lr(str(out / "sevir"), num_events=8, H=32, W=32, T=25)
    run_ranks("mesh", str(out))
    res = []
    for r in range(2):
        with open(out / f"mesh{r}.json") as f:
            res.append(json.load(f))
    return out, res


@pytest.mark.parametrize("batch,shards", [(8, 1), (8, 2), (8, 4), (6, 3), (4, 4)])
def test_local_batch_slice_is_the_jax_one(batch, shards):
    for i in range(shards):
        assert (torch_mesh.local_batch_slice(batch, shards, i)
                == jax_mesh.local_batch_slice(batch, shards, i))
    with pytest.raises(ValueError):
        torch_mesh.local_batch_slice(batch + 1, 2, 0)


def test_one_process_without_a_cluster(monkeypatch):
    """No cluster named: ``init_distributed`` returns False and starts
    nothing; the meshes are this process alone; a wrong 2-D shape raises."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    assert torch_mesh.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = torch_mesh.make_mesh(device="cpu")
    assert (mesh.size, mesh.index, mesh.distributed) == (1, 0, False)
    assert torch_mesh.make_data_mesh(6, device="cpu").size == 1
    assert torch_mesh.local_batch_slice(6) == slice(0, 6)
    x = torch.arange(6.0)
    assert torch.equal(torch_mesh.gather_batch(x, mesh), x)
    assert torch.equal(torch_mesh.all_reduce_sum(x, mesh), x)
    with pytest.raises(ValueError, match="ranks"):
        torch_mesh.make_2d_mesh(2, 2, device="cpu")
    with pytest.raises(AssertionError):
        jax_mesh.make_2d_mesh(2, 2, devices=jax.devices()[:3])


def test_a_named_cluster_that_cannot_be_reached_raises(monkeypatch):
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError):
        torch_mesh.init_distributed(coordinator_address=f"localhost:{free_port()}",
                                    num_processes=2, process_id=1, device="cpu", timeout=1.0)
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        torch_mesh.init_distributed(device="cpu")


def test_a_group_made_elsewhere_takes_the_card(monkeypatch):
    """A gloo group that ``init_distributed`` did not make (``torchrun`` and
    the caller's own ``init_process_group``): with no device named, a mesh
    takes the rank's card, ``cuda:LOCAL_RANK``, and raises without one; the
    CPU only when named.  Both ranks of the ``mesh`` task check the same of
    ``PreDiffPredictor(mesh="auto")``."""
    for k in CLUSTER_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch_mesh, "_RANK_DEVICE", {})
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                                         world_size=1, rank=0)
    try:
        assert torch_mesh.init_distributed() is True
        for make in (torch_mesh.make_mesh, lambda: torch_mesh.make_data_mesh(4)):
            with pytest.raises(RuntimeError, match="CUDA device"):
                make()
        assert torch_mesh.make_mesh(device="cpu").device == torch.device("cpu")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setenv("LOCAL_RANK", "1")
        assert torch_mesh.make_mesh().device == torch.device("cuda", 1)
        monkeypatch.setenv("LOCAL_RANK", "2")
        with pytest.raises(RuntimeError, match="LOCAL_RANK 2"):
            torch_mesh.make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_ranks_run_the_port_with_jax_blocked(ranks):
    """Each rank imported the port's parallel, serving-side and program
    modules with ``jax``, ``flax`` and ``prediff_tpu`` blocked."""
    _, res = ranks
    for got in res:
        assert all(got["jax_blocked"])
        assert {"prediff_torch.parallel.mesh", "prediff_torch.cli.train_sevirlr_prediff",
                "prediff_torch.evaluation.suite",
                "prediff_torch.datasets.prefetch"} <= set(got["port_imported"])


def test_two_ranks_mesh_and_collectives(ranks):
    _, res = ranks
    for got in res:   # a group init_distributed did not make, no device named: the card
        assert "CUDA device" in got["bare_group_predictor"]
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r, got in enumerate(res):
        assert got["mesh"] == [2, r, "gloo", "cpu"]
        for b, (size, member) in got["data_mesh"].items():
            want = len(jax_mesh.make_data_mesh(int(b), devices=jax.devices()[:2]).devices.ravel())
            assert size == want and member == (r < size), (b, r)
        assert got["mesh_2d"] == [2, 1]
        assert got["shard"] == x[2 * r:2 * r + 2].tolist()
        assert got["replicate"] == [7.0, 7.0]
        assert got["gather"] == [[0.0, 0.0], [1.0, 1.0]]
        assert got["all_reduce"] == 2.0
        mine = x[2 * r:2 * r + 2]
        assert got["prefetch"] == [mine.tolist(), (mine + 100).tolist()]


def _suite(tree):
    suite = ForecastEvalSuite(seq_len=6, threshold_list=(16, 74, 133),
                              fvd=FrechetVideoDistance(feature_fn=lambda v: v, num_features=12,
                                                       auto_t=True, reset_real_features=False))
    suite.load_state_tree(tree)
    return suite


def test_cross_process_reduce_is_the_merge_on_both_ranks(ranks):
    out, res = ranks
    before = [dict(np.load(out / f"suite_before{r}.npz")) for r in range(2)]
    assert not np.array_equal(before[0]["hits"], before[1]["hits"])
    want = _suite(before[0]).merge(_suite(before[1]))
    merged = want.state_tree()
    for r in range(2):
        after = dict(np.load(out / f"suite_after{r}.npz"))
        assert set(after) == set(merged)
        for k, v in merged.items():
            assert after[k].dtype == v.dtype and after[k].shape == v.shape, k
            assert np.array_equal(after[k], v), k
        assert res[r]["suite_compute"] == res[0]["suite_compute"]
    assert res[0]["suite_compute"] == pytest.approx(want.compute("test"), rel=1e-12, abs=0)


def test_test_set_evaluation_on_two_ranks(ranks):
    """Each rank scores its two test events; the metrics file (rank 0's
    alone: one record) equals the merge of the two shards' one-process runs
    bit for bit, and the dumps carry both ranks' names."""
    out, res = ranks
    with open(out / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 1
    merged = res[0]["merged_metrics"]
    assert {k for k in records[0] if k not in ("step", "time")} == set(merged)
    for k, v in merged.items():
        assert records[0][k] == v, k
    assert all(np.isfinite(v) for v in merged.values())
    npy = set(os.listdir(out / "run" / "npy"))
    for r in range(2):
        assert {f"batch0_rank{r}_sample0.npy", f"batch0_rank{r}_sample1_aligned.npy"} <= npy
        got = np.load(out / "run" / "npy" / f"batch0_rank{r}_sample1.npy")
        want = np.load(out / f"shard{r}" / "npy" / "batch0_rank0_sample1.npy")
        assert got.shape == (2, 2, 32, 32, 1) and np.array_equal(got, want)
    # the two shards scored other windows
    shards = [np.load(out / f"shard{r}_unaligned.npz") for r in range(2)]
    assert not np.array_equal(shards[0]["mse"], shards[1]["mse"])
