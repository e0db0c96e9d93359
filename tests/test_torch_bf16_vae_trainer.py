"""``VAETrainer(compute_dtype="bfloat16")`` against the JAX trainer's on the
tiny setup of tests/test_torch_vae_trainer.py (tests/test_training.py's
sizes; CPU): the VAE's encode and decode on its parameters cast to bf16 and
on the frames and latent in bf16, everything else f32.  The same randomized
weights, the posterior noise injected on both sides, the gradients each
state is given recorded; ``disc_start`` 1, as tests/test_torch_vae_trainer.py:
the first step runs before it (the GAN term weighed 0 in the total, the
adaptive weight still computed), the later ones at it.  Held: the first
step's losses within 1e-2 relative (floored at 1e-3 of the loss's scale),
the adaptive weight (a ratio of two gradient norms through the bf16
features) within 5e-2, both states' gradients at cosine >= 0.99 with JAX's
over every leaf, three steps with the stored parameters still f32 and every
loss finite."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_unet import randomize_flax
from test_torch_vae_trainer import (B, IMG, LOSS_KW, OPTIM, VAE_KW, _batch_stats, _jax_vae,
                                    injected)  # noqa: F401 (a fixture)

import prediff_tpu.training.optim as jax_optim
import prediff_tpu.training.train_state as jax_train_state
import prediff_tpu.training.vae_trainer as jax_vae_trainer
from prediff_tpu.training.losses import NLayerDiscriminator as JaxDisc
from prediff_torch.models.vae import AutoencoderKL
from prediff_torch.training import VAETrainer
from prediff_torch.training.losses import NLayerDiscriminator
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

LOSS_TOL, WEIGHT_TOL, MIN_COSINE, STEPS, DISC_START = 1e-2, 5e-2, 0.99, 3, 1


def _setup():
    jvae, jdisc = _jax_vae(), JaxDisc(input_nc=1, ndf=8, n_layers=1, use_actnorm=False)
    jtrainer = jax_vae_trainer.VAETrainer(vae=jvae, disc=jdisc, disc_start=DISC_START,
                                          optim_config=OPTIM, compute_dtype="bfloat16", **LOSS_KW)
    x0 = jnp.zeros((B, IMG, IMG, 1))
    vae_p = randomize_flax(jax.jit(jvae.init)(jax.random.PRNGKey(0), x0)["params"], 21)
    dvars = jax.jit(jdisc.init)(jax.random.PRNGKey(1), x0)
    disc_p = randomize_flax(dvars["params"], 22)
    stats = _batch_stats(dvars["batch_stats"], 23)
    gen = jax_train_state.EmaTrainState.create(
        {"vae": vae_p, "logvar": jnp.asarray(LOSS_KW["logvar_init"], jnp.float32)},
        jax_optim.build_optimizer(**OPTIM), use_ema=False)
    disc = jax_train_state.EmaTrainState.create(disc_p, jax_optim.build_optimizer(**OPTIM),
                                                use_ema=False)
    tvae = AutoencoderKL(**VAE_KW)
    tvae.load_state_dict(flax_params_to_torch(tvae, vae_p))
    tdisc = NLayerDiscriminator(input_nc=1, ndf=8, n_layers=1)
    tdisc.load_state_dict(flax_params_to_torch(tdisc, disc_p, stats))
    ttrainer = VAETrainer(tvae, tdisc, disc_start=DISC_START, optim_config=OPTIM,
                          compute_dtype="bfloat16", **LOSS_KW)
    return (jtrainer, gen, disc, stats), (ttrainer, *ttrainer.create_states())


def _cosine(got, want) -> float:
    g = np.concatenate([np.asarray(v, np.float64).ravel() for v in got])
    w = np.concatenate([np.asarray(v, np.float64).ravel() for v in want])
    return float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w)))


def test_bf16_steps_match_the_jax_trainer(injected):  # noqa: F811
    (jtrainer, gen, disc, stats), (ttrainer, tgen, tdisc_state, tstats) = _setup()
    assert ttrainer.compute_dtype == torch.bfloat16
    x = np.random.RandomState(25).rand(B, IMG, IMG, 1).astype(np.float32)
    for step in range(STEPS):
        gen, disc, stats, jlogs = jtrainer.train_step(gen, disc, stats, jax.random.PRNGKey(1),
                                                      jnp.asarray(x))
        tgen, tdisc_state, tstats, tlogs = ttrainer.train_step(tgen, tdisc_state, tstats, 1,
                                                               torch.from_numpy(x))
        assert all(torch.isfinite(v) for v in tlogs.values())
        tg_gen, tg_disc = injected["torch"][2 * step:2 * step + 2]
        want_disc = flax_params_to_torch(ttrainer.disc, injected["jax_disc"][step], stats)
        if step == DISC_START:   # the discriminator's first gradient (0 before disc_start)
            assert _cosine([g.numpy() for g in tg_disc],
                           [want_disc[n] for n in tdisc_state.params]) >= MIN_COSINE
        if step:
            continue
        assert not any(g.any() for g in tg_disc)
        assert not any(want_disc[n].any() for n in tdisc_state.params)
        scale = max(abs(float(v)) for v in jlogs.values())
        for k in ("train/total_loss", "train/rec_loss", "train/nll_loss", "train/kl_loss",
                  "train/g_loss", "train/disc_loss", "train/d_weight"):
            want = float(jlogs[k])
            tol = WEIGHT_TOL if k == "train/d_weight" else LOSS_TOL
            assert abs(float(tlogs[k]) - want) <= tol * max(abs(want), 1e-3 * scale), k
        want = flax_train_tree_to_torch(ttrainer.vae, injected["jax_gen"][0], name="vae")
        assert _cosine([g.numpy() for g in tg_gen], [want[n] for n in tgen.params]) >= MIN_COSINE
    assert tgen.step == STEPS
    assert all(p.dtype == torch.float32 for p in (*tgen.params.values(),
                                                  *tdisc_state.params.values()))
    assert all(p.dtype == torch.float32 for p in ttrainer.vae.parameters())
