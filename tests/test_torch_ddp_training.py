"""DDP training of the port on two gloo ranks on the CPU (ranks from
``tests/torch_parallel_worker.py``, task ``ddp``, started once for the file):
each rank holds its rows of a global batch of 4.

Against the JAX package on two of the 8 virtual CPU devices
(``make_mesh(jax.devices()[:2])``, the batch sharded, the parameters
replicated): the diffusion loss and every gradient at rate 0 with t, the
noise and the latents injected (``tests/test_torch_training.py``'s bar), the
alignment loss and every gradient at rate 0 with the posterior noise, t and
the noise injected, and two VAE-GAN steps of the JAX trainer's own jitted
step with ``mesh=`` (the posterior noise injected on both sides, BatchNorm
and ActNorm, ``disc_start`` 1) at ``tests/test_torch_vae_trainer.py``'s bar
(rel 1e-4): every log, ``d_weight``, both states' gradients and the new
batch statistics.  The control: the same BatchNorm steps with each rank's
own statistics (the all-reduce left out) miss that bar.  ActNorm's data
initialisation on the ranks takes the global batch's statistics.

Against one process of the port: at dropout 0.1 each rank's masks are its
rows of the one-process masks bit for bit, and with the element base left at
0 rank 1's masks repeat rank 0's (the control); after every micro-step of 2
optimizer steps at ``accum_steps`` 2 the ranks' parameters, EMA and Adam
moments are bit-equal, and after the last near one process on the global
batch: the Adam moments within ``MOMENTS_REL_L2``, the parameters and the
EMA within ``PARAMS_REL_L2`` and 4 lr of each element (the CPU products round
otherwise at a batch of 2 than of 4, and Adam moves a parameter whose
gradient is 0 but for rounding by about lr either way); the reduction once per optimizer step lies within
``ACCUM_REL_L2`` of the chosen reduction at every micro-step.  The program
``train_sevirlr_prediff --multihost --synthetic --max-steps 2 --device cpu``:
rank 0 alone writes checkpoints and logs, and a restore leaves both ranks
bit-equal.  ``accum_steps`` is the JAX script's formula.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_alignment_trainer import NET_KW, H, T, W, _nets
from test_torch_alignment_trainer import VAE_KW as ALIGN_VAE_KW
from test_torch_unet import randomize_flax
from test_torch_vae_trainer import (LOSS_KW, OPTIM, VAE_KW, _batch_stats, _close, _jax_vae,
                                    _stats_of)
from torch_parallel_worker import start_ranks, wait_ranks

import prediff_tpu.training.optim as jax_optim
import prediff_tpu.training.train_state as jax_train_state
import prediff_tpu.training.vae_trainer as jax_vae_trainer
import prediff_tpu.utils.distributions as jax_dist
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.models.vae import AutoencoderKL as JaxVAE
from prediff_tpu.parallel.mesh import batch_sharding, make_mesh, replicated_sharding
from prediff_tpu.training.alignment_trainer import AlignmentTrainer as JaxAlignmentTrainer
from prediff_tpu.training.losses import NLayerDiscriminator as JaxDisc
from prediff_torch.cli.train_sevirlr_prediff import accum_steps
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet, build_vae
from prediff_torch.models.init import init_params_
from prediff_torch.models.vae import AutoencoderKL
from prediff_torch.ops import dropout
from prediff_torch.training.losses import NLayerDiscriminator
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
B = 4                   # the global batch, 2 a rank
TOL = 1e-4              # against JAX: f32 on both sides, the sums in another order
# two ranks against one process on the global batch after 2 optimizer steps: the CPU
# products round otherwise at a batch of 2 than of 4 (the gradients' mean 1.1e-6 rel-L2
# apart in the Adam moments, measured), and Adam turns a gradient that is 0 but for
# rounding into a step of about lr of either sign, so the parameters and the EMA lie
# 1.6e-5 / 1.2e-5 apart (measured), each element within 2 steps of 2 lr
MOMENTS_REL_L2 = 5e-6
PARAMS_REL_L2 = 5e-5
LR = 1e-3
ACCUM_REL_L2 = 1e-6     # the gradient mean reduced once against every micro-step
ALIGN = dict(steps=10, scale=0.7)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs and weights, both ranks' arrays, and the JAX references
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("ddp")
    rs = np.random.RandomState(17)
    inputs = {"mask_x": rs.randn(B, 2, 4, 4, 8), "mask_t": np.array([1, 3, 5, 7]),
              "mask_cond": rs.randn(B, 3, 4, 4, 8),
              "train_x": rs.rand(4, B, 2, 32, 32, 1), "train_y": rs.rand(4, B, 3, 32, 32, 1)}
    weights, ref = {}, {}
    tcfg = load_config(prediff_default_config, TINY)
    gen = torch.Generator().manual_seed(4)
    weights["diffusion_train"] = {
        "unet": init_params_(build_unet(tcfg), gen, randomize=True).state_dict(),
        "vae": init_params_(build_vae(tcfg), gen, randomize=True).state_dict()}

    # the diffusion loss at rate 0 (tests/test_torch_training.py's `both`)
    jld, jparams = jax_build_pipeline(jax_load_config(jax_default_config, TINY),
                                      with_alignment=False)
    unet_p = randomize_flax(jparams["unet"], 11)
    weights["diffusion"] = {"unet": flax_params_to_torch(build_unet(tcfg), unet_p),
                            "vae": flax_params_to_torch(build_vae(tcfg),
                                                        randomize_flax(jparams["vae"], 12))}
    inputs.update(z=rs.randn(B, 2, 4, 4, 8), zc=rs.randn(B, 3, 4, 4, 8), t=np.array([1, 6, 3, 0]),
                  noise=rs.randn(B, 2, 4, 4, 8), logvar=0.3 * rs.randn(jld.num_timesteps))

    # the alignment net at rate 0 (tests/test_torch_alignment_trainer.py's `_nets`)
    (jnet, jvae_a, net_p, avae_p), (tnet, tvae_a) = _nets(0.0)
    weights["align_net"], weights["align_vae"] = tnet.state_dict(), tvae_a.state_dict()
    inputs.update(align_x=rs.rand(B, T, H, W, 1), align_y=rs.rand(B, T, H, W, 1),
                  align_t=np.array([3, 8, 0, 5]), align_noise=rs.randn(B, *NET_KW["input_shape"]),
                  align_eps=rs.randn(B * T, 2, 4, 2))

    # the VAE-GAN (tests/test_torch_vae_trainer.py's sizes), BatchNorm and ActNorm
    img = 8
    x0 = jnp.zeros((B, img, img, 1))
    jvae = _jax_vae()
    vae_p = randomize_flax(jax.jit(jvae.init)(jax.random.PRNGKey(0), x0)["params"], 1)
    jsetup = {}
    for norm, actnorm in (("batchnorm", False), ("actnorm", True)):
        jdisc = JaxDisc(input_nc=1, ndf=8, n_layers=1, use_actnorm=actnorm)
        dvars = jax.jit(jdisc.init)(jax.random.PRNGKey(1), x0)
        disc_p = randomize_flax(dvars["params"], 2)
        stats = _batch_stats(dvars["batch_stats"], 3) if "batch_stats" in dvars else {}
        tvae = AutoencoderKL(**VAE_KW)
        weights[f"vae_{norm}"] = flax_params_to_torch(tvae, vae_p)
        tdisc = NLayerDiscriminator(input_nc=1, ndf=8, n_layers=1, use_actnorm=actnorm)
        weights[f"disc_{norm}"] = flax_params_to_torch(tdisc, disc_p, stats)
        jsetup[norm] = (jdisc, disc_p, stats, tvae, tdisc)
    inputs.update(vae_x=rs.rand(B, img, img, 1), vae_eps=rs.randn(B, 2, 2, 2))
    inputs = {k: np.asarray(v, np.float32) for k, v in inputs.items()}
    np.savez(out / "inputs.npz", **inputs)
    torch.save(weights, out / "weights.pt")
    spec = {"align_net": {**NET_KW, "input_shape": list(NET_KW["input_shape"])},
            "align_vae": {k: list(v) if isinstance(v, tuple) else v
                          for k, v in ALIGN_VAE_KW.items()},
            "align_steps": ALIGN["steps"], "align_scale": ALIGN["scale"],
            "vae": {k: list(v) if isinstance(v, tuple) else v for k, v in VAE_KW.items()},
            "vae_optim": OPTIM, "vae_loss": LOSS_KW}
    with open(out / "spec.json", "w") as f:
        json.dump(spec, f)

    procs = start_ranks("ddp", str(out))
    try:
        jmesh = make_mesh(jax.devices()[:2])
        repl, data = replicated_sharding(jmesh), batch_sharding(jmesh)
        j = {k: jnp.asarray(v) for k, v in inputs.items()}

        def diffusion_loss(p, z, zc, t, noise):
            return jld.p_losses(p["unet"], p["logvar"], z, zc, t, noise, train=False)

        (loss, loss_dict), grads = jax.jit(
            jax.value_and_grad(diffusion_loss, has_aux=True),
            in_shardings=(repl, data, data, data, data))(
                {"unet": unet_p, "logvar": j["logvar"]}, j["z"], j["zc"],
                j["t"].astype(jnp.int32), j["noise"])
        ref["diffusion"] = (float(loss), {k: float(v) for k, v in loss_dict.items()},
                            jax.tree_util.tree_map(np.asarray, grads))

        jtr = JaxAlignmentTrainer(
            model_apply=jnet.apply, vae_params=avae_p, timesteps=ALIGN["steps"],
            scale_factor=ALIGN["scale"], mesh=jmesh,
            vae_apply_encode=lambda v, f: jvae_a.apply(v, f, method=JaxVAE.encode_moments))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                       lambda self, rng: self.mean + self.std * j["align_eps"])
            mp.setattr(jax.random, "randint", lambda *a, **k: j["align_t"].astype(jnp.int32))
            mp.setattr(jax.random, "normal", lambda *a, **k: j["align_noise"])
            (loss, loss_dict), grads = jax.jit(jax.value_and_grad(
                lambda p, x, y: jtr.loss_fn(p, jax.random.PRNGKey(5), x, y, train=True),
                has_aux=True), in_shardings=(repl, data, data))(net_p, j["align_x"],
                                                                j["align_y"])
        ref["align"] = (float(loss), {k: float(v) for k, v in loss_dict.items()},
                        flax_params_to_torch(tnet, jax.tree_util.tree_map(np.asarray, grads)))

        for norm, (jdisc, disc_p, stats, tvae, tdisc) in jsetup.items():
            ref[norm] = _jax_vae_steps(jmesh, jvae, jdisc, vae_p, disc_p, stats, j, tvae, tdisc)
    finally:
        wait_ranks(procs, "ddp", timeout=400.0)
    ranks = [dict(np.load(out / f"ddp{r}.npz")) for r in range(2)]
    return inputs, ranks, ref


def _jax_vae_steps(jmesh, jvae, jdisc, vae_p, disc_p, stats, j, tvae, tdisc):
    """Two steps of the JAX trainer's jitted step with ``mesh=``: the logs,
    the gradients each state was given and the statistics after each step,
    under the port's names."""
    jtrainer = jax_vae_trainer.VAETrainer(vae=jvae, disc=jdisc, disc_start=1, optim_config=OPTIM,
                                          mesh=jmesh, **LOSS_KW)
    gen = jax_train_state.EmaTrainState.create(
        {"vae": vae_p, "logvar": jnp.asarray(LOSS_KW["logvar_init"], jnp.float32)},
        jax_optim.build_optimizer(**OPTIM), use_ema=False)
    disc = jax_train_state.EmaTrainState.create(disc_p, jax_optim.build_optimizer(**OPTIM),
                                                use_ema=False)
    recorded = {"gen": [], "disc": []}
    apply = jax_train_state.EmaTrainState.apply_gradients

    def record(self, grads):
        key = "gen" if "logvar" in grads else "disc"
        jax.debug.callback(lambda g: recorded[key].append(jax.tree_util.tree_map(np.asarray, g)),
                           grads)
        return apply(self, grads)

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                   lambda self, rng: self.mean + self.std * j["vae_eps"])
        mp.setattr(jax_train_state.EmaTrainState, "apply_gradients", record)
        for step in range(2):
            gen, disc, stats, logs = jtrainer.train_step(gen, disc, stats, jax.random.PRNGKey(1),
                                                         j["vae_x"])
            jax.block_until_ready(logs)
            out.append({"log": {k: np.asarray(v) for k, v in logs.items()},
                        "stats": {k: np.asarray(v) for k, v in _stats_of(stats).items()}})
    for step in range(2):
        out[step]["gen"] = flax_train_tree_to_torch(tvae, recorded["gen"][step], name="vae")
        out[step]["disc"] = flax_params_to_torch(tdisc, recorded["disc"][step], stats)
    return out


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _masks(res, name):
    return [res[k] for k in sorted((k for k in res if k.startswith(f"mask_{name}_")),
                                   key=lambda k: int(k.rsplit("_", 1)[1]))]


def test_masks_are_each_ranks_rows_of_one_process(runs):
    _, ranks, _ = runs
    for r, res in enumerate(ranks):
        one, mine = _masks(res, "one"), _masks(res, "mine")
        # first_proj, then per stage and direction: the time block and 3 x (attention, FFN)
        assert len(one) == len(mine) == 1 + 4 * (1 + 3 * 4)
        for m_one, m_mine in zip(one, mine):
            rows = m_one.reshape(B, -1)[2 * r:2 * r + 2]
            assert np.array_equal(m_mine.reshape(2, -1), rows)
        assert np.array_equal(one[0], ranks[0]["mask_one_0"])


def test_base_zero_control_repeats_rank_zeros_masks(runs):
    _, ranks, _ = runs
    base0 = [_masks(res, "base0") for res in ranks]
    assert all(np.array_equal(a, b) for a, b in zip(*base0))       # rank 1 repeats rank 0
    one = _masks(ranks[1], "one")
    assert not all(np.array_equal(m.reshape(2, -1), o.reshape(B, -1)[2:])
                   for m, o in zip(base0[1], one))


@pytest.mark.parametrize("base", [0, 3, 4, 1000, 2 ** 33 + 6])
def test_keep_mask_with_a_base_is_a_slice_of_the_whole(base):
    if base < 10_000:
        whole = dropout.keep_mask(21, 4, 1, (base + 37,), 0.3)
        assert torch.equal(dropout.keep_mask(21, 4, 1, (37,), 0.3, base=base), whole[base:])
    bits = dropout.random_bits(21, 4, 1, 9, base=base)
    block = dropout.random_bits(21, 4, 1, 16, base=4 * (base // 4))   # whole Philox blocks
    assert torch.equal(bits, block[base % 4:base % 4 + 9])
    assert dropout.kernel_bases((base, 8)) == (base % 4 == 0)


def test_ranks_bit_equal_after_every_step(runs):
    _, (r0, r1), _ = runs
    assert list(r0["train_prints"]) == list(r1["train_prints"])
    assert len(set(r0["train_prints"])) == 4                        # every micro-step moves
    for k in ("params", "ema", "exp_avg", "exp_avg_sq"):
        assert np.array_equal(r0[f"train_{k}"], r1[f"train_{k}"]), k
    assert np.array_equal(r0["train_logs"], r1["train_logs"])


def test_steps_near_one_process_on_the_global_batch(runs):
    _, (r0, _), _ = runs
    for k in ("exp_avg", "exp_avg_sq"):
        assert _rel_l2(r0[f"train_{k}"], r0[f"train_one_{k}"]) <= MOMENTS_REL_L2, k
    for k in ("params", "ema"):
        assert _rel_l2(r0[f"train_{k}"], r0[f"train_one_{k}"]) <= PARAMS_REL_L2, k
        assert np.abs(r0[f"train_{k}"] - r0[f"train_one_{k}"]).max() <= 4 * LR, k
    np.testing.assert_allclose(r0["train_logs"], r0["train_one_logs"], rtol=1e-4, atol=1e-6)
    assert "grad_norm" in list(r0["train_log_keys"])


def test_reduction_once_per_optimizer_step_near_every_micro_step(runs):
    _, (r0, r1), _ = runs
    assert np.array_equal(r0["accum_every"], r1["accum_every"])
    assert _rel_l2(r0["accum_once"], r0["accum_every"]) <= ACCUM_REL_L2


def test_diffusion_gradients_match_jax(runs):
    _, (r0, r1), ref = runs
    loss, loss_dict, grads = ref["diffusion"]
    want = flax_train_tree_to_torch(build_unet(load_config(prediff_default_config, TINY)), grads)
    np.testing.assert_allclose(float(r0["diff_loss/loss"]), loss, rtol=TOL)
    for k, v in loss_dict.items():
        np.testing.assert_allclose(float(r0[f"diff_loss/{k}"]), v, rtol=TOL, atol=TOL, err_msg=k)
    got = {k[len("diff_grad/"):]: v for k, v in r0.items() if k.startswith("diff_grad/")}
    assert sorted(f"unet.{k}" if k != "logvar" else k for k in got) == sorted(want)
    for name, g in got.items():
        w = want[name if name == "logvar" else f"unet.{name}"].numpy()
        # tests/test_torch_training.py's bar: of the leaf's scale, at least 1e-3
        scale, err = max(float(np.abs(w).max()), 1e-3), float(np.abs(g - w).max())
        assert err <= TOL * max(scale, 1.0) and err <= 1e-2 * scale, name
        assert np.array_equal(g, r1[f"diff_grad/{name}"])


def test_alignment_gradients_match_jax(runs):
    _, (r0, r1), ref = runs
    loss, loss_dict, want = ref["align"]
    for k, v in loss_dict.items():
        _close(k, r0[f"align_loss/{k}"], v)
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    names = [k[len("align_grad/"):] for k in r0 if k.startswith("align_grad/")]
    assert sorted(names) == sorted(want)
    for name in names:
        _close(name, r0[f"align_grad/{name}"], want[name].numpy(), floor=floor)
        assert np.array_equal(r0[f"align_grad/{name}"], r1[f"align_grad/{name}"])


def _vae_misses(res, case, want) -> list:
    """The names whose port value lies past TOL of the JAX step's (the same
    rule as ``_close``), over both steps."""
    missed = []
    for step in range(2):
        for kind in ("gen", "disc"):
            names = [k.split("/", 3)[3] for k in res if k.startswith(f"{case}/{step}/{kind}/")]
            # the discriminator's tree also holds its running statistics
            assert names and set(names) <= set(want[step][kind]), kind
            floor = 1e-3 * max(float(want[step][kind][n].abs().max()) for n in names)
            for n in names:
                w = want[step][kind][n].numpy()
                scale = max(float(np.abs(w).max()), floor, 1e-30)
                if float(np.abs(res[f"{case}/{step}/{kind}/{n}"] - w).max()) > TOL * scale:
                    missed.append(f"{step} {kind} {n}")
        for k, w in list(want[step]["log"].items()) + list(want[step]["stats"].items()):
            kind = "log" if k in want[step]["log"] else "stats"
            got = res[f"{case}/{step}/{kind}/{k}"]
            if np.abs(got - w).max() > TOL * max(float(np.abs(w).max()), 1e-30):
                missed.append(f"{step} {k}")
    return missed


@pytest.mark.parametrize("norm", ["batchnorm", "actnorm"])
def test_two_vae_gan_steps_match_the_jax_trainer_on_a_mesh(runs, norm):
    _, (r0, r1), ref = runs
    # a gradient that is 0 but for rounding (the disc's last bias when every logit
    # lies inside the hinge's margin) sits under the floor and passes on it
    assert _vae_misses(r0, norm, ref[norm]) == []
    assert float(r0[f"{norm}/1/log/train/disc_factor"]) == 1.0
    assert float(r0[f"{norm}/0/log/train/d_weight"]) > 0
    assert str(r0[f"{norm}/print"]) == str(r1[f"{norm}/print"])      # the ranks bit-equal


def test_vae_gan_control_without_the_statistics_reduce_misses(runs):
    _, (r0, _), ref = runs
    missed = _vae_misses(r0, "batchnorm_local", ref["batchnorm"])
    assert any("stats" in m or "main." in m for m in missed), missed
    assert any(" gen " in f" {m} " or " disc " in f" {m} " for m in missed), missed


def test_actnorm_initialises_from_the_global_batch(runs):
    _, (r0, r1), _ = runs
    assert np.array_equal(r0["actnorm_init_mesh"], r1["actnorm_init_mesh"])
    np.testing.assert_allclose(r0["actnorm_init_mesh"], r0["actnorm_init_one"], rtol=1e-5,
                               atol=1e-6)


def test_program_rank0_writes_and_a_restore_leaves_the_ranks_equal(runs):
    _, (r0, r1), _ = runs
    assert int(r0["cli_saves"]) >= 2 and int(r1["cli_saves"]) == 0   # a val checkpoint, ckpt_last
    assert int(r0["cli_logs"]) >= 1 and int(r1["cli_logs"]) == 0
    assert str(r0["cli_restored_print"]) == str(r1["cli_restored_print"])
    assert int(r0["cli_restored_step"]) == int(r1["cli_restored_step"]) == 2


@pytest.mark.parametrize("micro,devices,nodes", [(2, 1, 1), (1, 2, 1), (2, 4, 1), (1, 8, 2),
                                                  (3, 2, 1), (8, 8, 4)])
def test_accum_steps_is_the_jax_scripts_formula(micro, devices, nodes):
    cfg = load_config(prediff_default_config, TINY)
    cfg.optim.micro_batch_size, cfg.optim.total_batch_size = micro, 64
    # scripts/train_sevirlr_prediff.py: total // (micro x the mesh's devices x --nodes)
    want = max(1, cfg.optim.total_batch_size // (cfg.optim.micro_batch_size * devices * nodes))
    assert accum_steps(cfg, devices, nodes) == want
