"""K diffusion micro-steps per call on a mesh (``DiffusionTrainer.train_step_scan``
with ``mesh=``) on two gloo ranks on the CPU (ranks from
``tests/torch_parallel_worker.py``, task ``scan``, started once for the
file), each its rows of a global batch of 4: the micro-step in its two parts
around the host all-reduce (``training/step_graphs.py``), run eagerly.

Against K eager ``train_step`` calls on the mesh at the recipe's rates 0.1,
bit for bit on each rank, alone and with ``remat_unet``, bf16 moments and a
bf16 shadow together; the ranks bit-equal to each other.  Against the JAX
trainer's ``train_step_scan`` with ``mesh=`` on two of the 8 virtual CPU
devices (the chunk sharded ``P(None, "data")``) at rates 0, the global
batch's draws injected on both sides (each rank its rows), at the bars of
``tests/test_torch_scan_trainer.py``'s comparison.  The program
``train_sevirlr_prediff --multihost`` with ``optim.steps_per_call: 2``: each
rank's chunks are its own batches stacked two at a time, and the run ends in
the state of the run with 1, bit for bit, on both ranks.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scan_trainer import OPTIM, RATES, TINY
from test_torch_training import TOL_GRAD, TOL_STEP
from test_torch_unet import randomize_flax
from torch_parallel_worker import start_ranks, wait_ranks

import prediff_tpu.utils.distributions as jax_dist
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.parallel.mesh import make_mesh
from prediff_tpu.training.diffusion_trainer import DiffusionTrainer as JaxDiffusionTrainer
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet, build_vae
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

B = 4                   # the global batch, 2 a rank
K = 3                   # micro-steps a call: accumulate, update, accumulate
OPTINS = dict(remat_unet=True, state_dtype="bfloat16", ema_dtype="bfloat16")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' arrays and the JAX mesh scan's state and metrics
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("scan")
    tcfg = load_config(prediff_default_config, TINY)
    L = tcfg.layout
    rs = np.random.RandomState(25)
    latent = tuple(tcfg.model.diffusion.latent_shape)
    inputs = {"train_x": rs.rand(K, B, L.out_len, L.img_height, L.img_width, 1),
              "train_y": rs.rand(K, B, L.in_len, L.img_height, L.img_width, 1),
              "t": np.array([3, 7, 1, 5]), "noise": rs.randn(B, *latent),
              "eps": rs.randn(B * latent[0], *latent[1:])}
    inputs = {k: np.asarray(v, np.int64 if k == "t" else np.float32) for k, v in inputs.items()}
    np.savez(out / "inputs.npz", **inputs)
    jld, jparams = jax_build_pipeline(jax_load_config(jax_default_config, TINY),
                                      with_alignment=False)
    unet_p = randomize_flax(jparams["unet"], 41)
    vae_p = randomize_flax(jparams["vae"], 42)
    torch.save({"unet": flax_params_to_torch(build_unet(tcfg), unet_p),
                "vae": flax_params_to_torch(build_vae(tcfg), vae_p)}, out / "weights.pt")
    with open(out / "spec.json", "w") as f:
        json.dump({"k": K, "optim": OPTIM, "rates": RATES, "optins": OPTINS}, f)

    procs = start_ranks("scan", str(out))
    try:
        j = {k: jnp.asarray(v) for k, v in inputs.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                       lambda self, rng: self.mean + self.std * j["eps"])
            mp.setattr(jax.random, "randint", lambda *a, **k: j["t"].astype(jnp.int32))
            mp.setattr(jax.random, "normal", lambda *a, **k: j["noise"])
            jtr = JaxDiffusionTrainer(jld, vae_p, optim_config=OPTIM,
                                      mesh=make_mesh(jax.devices()[:2]))
            jstate, jmets = jtr.train_step_scan(jtr.create_state(unet_p), jax.random.PRNGKey(0),
                                                j["train_x"], j["train_y"])
            jmets = jax.device_get(jmets)
        unet = build_unet(tcfg)
        ref = {"metrics": jmets, "step": int(jstate.step),
               "params": flax_train_tree_to_torch(unet, jax.tree_util.tree_map(
                   np.asarray, jstate.params)),
               "ema": flax_train_tree_to_torch(unet, jax.tree_util.tree_map(
                   np.asarray, jstate.ema_params))}
    finally:
        wait_ranks(procs, "scan", timeout=300.0)
    ranks = [dict(np.load(out / f"scan{r}.npz")) for r in range(2)]
    return ranks, ref


@pytest.mark.parametrize("case", ["plain", "optins"])
def test_mesh_scan_is_k_eager_mesh_steps_on_each_rank(runs, case):
    ranks, _ = runs
    for r, res in enumerate(ranks):
        assert bool(res[f"{case}_split"]), r            # gloo: the two parts around the host
        assert bool(res[f"{case}_equal"]), (r, case)
        assert len(set(res[f"{case}_loss"].tolist())) == K
    assert str(ranks[0][f"{case}_print"]) == str(ranks[1][f"{case}_print"])
    assert ("torch.bfloat16" in ranks[0][f"{case}_dtypes"]) == (case == "optins")
    assert list(ranks[0]["rows"]) == [0, 2] and list(ranks[1]["rows"]) == [2, 4]


def test_mesh_scan_matches_the_jax_scan_on_a_mesh(runs):
    """The stacked metrics within ``TOL_GRAD``; the parameters and the EMA
    within ``TOL_STEP`` but for the elements whose first Adam update took the
    other sign (a gradient of 0 up to rounding), at most 1e-4 of them, each
    within twice the update's rate; both ranks bit-equal."""
    (r0, r1), ref = runs
    assert list(r0["jax_counters"]) == [ref["step"], 1, 1]
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(r0[f"jax_met/{k}"], np.asarray(v), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)
    rate = OPTIM["lr"] * OPTIM["warmup_min_lr_ratio"]
    flipped = total = 0
    names = [k[len("jax_param/"):] for k in r0 if k.startswith("jax_param/")]
    assert sorted(names) == sorted(ref["params"])
    for k in names:
        for kind, want in (("jax_param", ref["params"][k]), ("jax_ema", ref["ema"][k])):
            got = r0[f"{kind}/{k}"]
            assert np.array_equal(got, r1[f"{kind}/{k}"]), (kind, k)
            err = np.abs(got - want.numpy())
            flipped += int((err > TOL_STEP * (1.0 + np.abs(want.numpy()))).sum())
            total += err.size
            assert float(err.max()) <= 2.0 * rate, (kind, k, float(err.max()))
    assert flipped <= 1e-4 * total, (flipped, total)


def test_program_multihost_chunks_are_each_ranks_rows(runs):
    ranks, _ = runs
    for res in ranks:
        batches, chunks = res["cli1_batches"], res["cli2_chunks"]
        assert chunks.shape[:2] == (2, 2) and batches.shape[0] == 4
        assert np.array_equal(chunks.reshape(batches.shape), batches)
        assert str(res["cli1_print"]) == str(res["cli2_print"])
    assert not np.array_equal(ranks[0]["cli1_batches"], ranks[1]["cli1_batches"])
    assert str(ranks[0]["cli2_print"]) == str(ranks[1]["cli2_print"])
