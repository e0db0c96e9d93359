"""Sharded forecasts on the card (``configs/tiny_smoke.yaml``, seeded
randomized weights): two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on
one device; gloo's collectives go through the host), whose unguided steps
replay captured graphs and whose guided steps run eagerly, against one
process on the same card; and an NCCL group of one rank, whose guided steps
capture the all-reduce, bit-equal to its eager chain and to the call without
a mesh.  The ranks are processes of ``tests/torch_parallel_worker.py``.
Every test needs a CUDA device and skips without one.  This file imports no
JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py
"""
import numpy as np
import pytest
import torch
from torch_parallel_worker import run_ranks

pytestmark = pytest.mark.cuda

UNGUIDED_REL_L2 = 1e-5   # sharded against one process on one card
GUIDED_REL_L2 = 1e-4     # the energy's sum over the ranks runs in another order


@pytest.fixture
def dev():
    """The card; decided per test, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_two_gloo_ranks_on_one_card_match_one_process(dev, tmp_path):
    run_ranks("cuda", str(tmp_path), world=2, timeout=600.0)
    ranks = [dict(np.load(tmp_path / f"cuda2_rank{r}.npz")) for r in range(2)]
    for res in ranks:
        assert res["ddpm"].shape == (4, 1, 2, 32, 32, 1)
        assert rel_l2(res["ddpm"], res["ddpm_one"]) <= UNGUIDED_REL_L2
        assert rel_l2(res["guided"], res["guided_one"]) <= GUIDED_REL_L2
        assert res["ddpm_captures"] >= 1 and res["guided_captures"] == 0
        assert res["routes"].all() and res["routes"].size >= 1
    for k in ("ddpm", "guided"):
        assert np.array_equal(ranks[0][k], ranks[1][k])


def test_nccl_rank_captures_the_all_reduce(dev, tmp_path):
    run_ranks("cuda", str(tmp_path), world=1, timeout=600.0)
    res = dict(np.load(tmp_path / "cuda1_rank0.npz"))
    assert res["guided_captures"] >= 1 and res["captured_all_reduce"] >= 1
    assert np.array_equal(res["guided"], res["guided_eager"])
    assert np.array_equal(res["guided"], res["guided_one"])
