"""Sharded forecasts on two gloo ranks on the CPU (``configs/tiny_smoke.yaml``,
randomized weights, every leaf): the port's
``LatentDiffusion.sample(mesh=)`` against the JAX package's sharded
``sample(mesh=make_mesh(jax.devices()[:2]))`` (its ``shard_map`` chain on two
of the 8 virtual CPU devices), and against one process of the port.

Against JAX the chains are noise-free (x_T given, DDPM at temperature 0, DDIM
at eta 0), at ``tests/test_torch_chain.py``'s bar (rtol = atol = 1e-4): a
4-step DDPM, a 4-step DDIM and a guided 4-step DDIM chain.  The guided one
sums the energy over both ranks; the same chain with the all-reduce left out
must miss the bar, so the test cannot pass without the sum.  Against one
process, with noise from one seed: each rank's x_T and step noise are its
rows of the one-process draw bit for bit, both ranks return the same tensor,
a noise-free sharded chain is bit for bit one process's on each rank's rows,
and the ensemble is within rel-L2 5e-6 of the one-process one (measured
1.40e-6 unguided, 1.35e-6 guided: the UNet's CPU products round otherwise on
a batch of 2 than of 4, by up to 1.1e-5 in one forward, while the encode and
the decode are bit-equal); a generator seeded otherwise on rank 1 draws rank
0's numbers; a batch of 3 on 2 ranks runs whole on both, bit-equal to one
process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import start_ranks, wait_ranks

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.parallel.mesh import make_mesh
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_alignment_model, build_unet, build_vae
from prediff_torch.models.init import init_params_
from prediff_torch.utils.checkpoint import DERIVED_BUFFERS
from prediff_torch.utils.convert import torch_params_to_flax

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
ATOL = RTOL = 1e-4       # f32 on both sides, as tests/test_torch_chain.py
ENSEMBLE_REL_L2 = 5e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX pipeline and weights, the inputs, and both ranks' arrays (the
    ranks run while the JAX pipeline is built)."""
    out = tmp_path_factory.mktemp("sampling")
    tcfg = load_config(prediff_default_config, TINY)
    gen = torch.Generator().manual_seed(5)
    models = {k: init_params_(build(tcfg), gen, randomize=True)
              for k, build in (("unet", build_unet), ("vae", build_vae),
                               ("align", build_alignment_model))}
    torch.save({k: m.state_dict() for k, m in models.items()}, out / "weights.pt")
    rs = np.random.RandomState(7)
    inputs = {"y": rs.rand(2, 3, 32, 32, 1).astype(np.float32),
              "x_T": rs.randn(2, 2, 4, 4, 8).astype(np.float32),
              "avg": np.array([[0.3], [0.7]], np.float32)}
    np.savez(out / "inputs.npz", **inputs)
    procs = start_ranks("sampling", str(out))
    try:
        ld, _ = jax_build_pipeline(jax_load_config(jax_default_config, TINY),
                                   with_alignment=True)
        jparams = {k: torch_params_to_flax(m, m.state_dict(), skip_suffixes=DERIVED_BUFFERS)
                   for k, m in models.items()}
    finally:
        wait_ranks(procs, "sampling")
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    return ld, jparams, inputs, ranks


DDIM = dict(sampler="ddim", ddim_steps=4, ddim_eta=0.0)
JAX_SHARDED = {}   # chain -> JAX's sharded forecast, each computed once


def jax_sharded(runs, chain):
    ld, jparams, inputs, _ = runs
    if chain not in JAX_SHARDED:
        kw = {"ddpm": dict(timesteps=4), "ddim": DDIM,
              "guided_ddim": dict(DDIM, use_alignment=True,
                                  alignment_kwargs={"avg_x_gt": jnp.asarray(inputs["avg"])})}
        JAX_SHARDED[chain] = np.asarray(ld.sample(
            jparams["unet"], jparams["vae"], jax.random.PRNGKey(0), jnp.asarray(inputs["y"]),
            align_params=jparams["align"], x_T=jnp.asarray(inputs["x_T"]), temperature=0.0,
            mesh=make_mesh(jax.devices()[:2]), **kw[chain]))
    return JAX_SHARDED[chain]


@pytest.mark.parametrize("chain", ["ddpm", "ddim", "guided_ddim"])
def test_sharded_chain_matches_jax_sharded(runs, chain):
    ranks = runs[3]
    want = jax_sharded(runs, chain)
    assert want.shape == (2, 2, 32, 32, 1)
    for r in range(2):
        np.testing.assert_allclose(ranks[r][chain], want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(ranks[0][chain], ranks[1][chain])
    if chain == "ddpm":   # sharding alone: bit for bit one process at the rank's batch
        for r in range(2):
            assert np.array_equal(ranks[r]["ddpm"][r:r + 1], ranks[r]["ddpm_rows_one"])
    if chain == "guided_ddim":   # each rank's energy alone misses the bar
        alone = ranks[0]["guided_ddim_no_reduce"]
        assert not np.allclose(alone, want, rtol=RTOL, atol=ATOL)
        unguided = jax_sharded(runs, "ddim")
        assert np.abs(want - unguided).max() > 10 * np.abs(ranks[0][chain] - want).max()


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_sharded_ensemble_draws_the_one_process_noise(runs):
    _, _, _, ranks = runs
    for res in ranks:
        assert np.array_equal(res["ens_x_T"], res["ens_one_x_T_rows"])
        assert np.array_equal(res["ens_noise"], res["ens_one_noise_rows"])
        assert res["ens"].shape == (4, 1, 2, 32, 32, 1)
        assert rel_l2(res["ens"], res["ens_one"]) <= ENSEMBLE_REL_L2
        assert rel_l2(res["ens_guided"], res["ens_guided_one"]) <= ENSEMBLE_REL_L2
        assert np.array_equal(res["ens_seed_rank"], ranks[0]["ens"])
    for k in ("ens", "ens_guided"):
        assert np.array_equal(ranks[0][k], ranks[1][k])
    assert not np.array_equal(ranks[0]["ens_x_T"], ranks[1]["ens_x_T"])   # each its rows


def test_energy_sums_over_the_ranks(runs):
    _, _, _, ranks = runs
    for res in ranks:
        assert res["energy"] == pytest.approx(float(res["energy_one"]), rel=1e-6)
    assert np.array_equal(ranks[0]["energy"], ranks[1]["energy"])


def test_indivisible_batch_runs_whole_on_every_rank(runs):
    """B=3 on 2 ranks runs whole on both, from rank 0's generator state (rank
    1's generator is seeded otherwise): one process's bits on both."""
    _, _, _, ranks = runs
    for res in ranks:
        assert res["indivisible"].shape == (3, 2, 32, 32, 1)
        assert np.array_equal(res["indivisible"], res["indivisible_one"])
    assert np.array_equal(ranks[0]["indivisible"], ranks[1]["indivisible"])
