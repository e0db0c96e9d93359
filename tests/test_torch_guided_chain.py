"""Guided and DDIM chains end to end (encode, reverse steps, decode) on
configs/tiny_smoke.yaml: the port against ``LatentDiffusion.sample`` of the
JAX package with the same randomized UNet, VAE and alignment weights, the
same x_T, temperature 0 (DDPM) or eta 0 (DDIM) (CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.diffusion import schedule as jax_schedule
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.diffusion import schedule
from prediff_torch.factory import build_alignment_model, build_pipeline, build_unet, build_vae
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 on both sides: a few UNet steps, the alignment gradient and the VAE
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def pipelines():
    jcfg = jax_load_config(jax_default_config, TINY)
    ld, params = jax_build_pipeline(jcfg, with_alignment=True)
    jparams = {k: randomize_flax(params[k], seed) for k, seed in (("unet", 5), ("vae", 6),
                                                                    ("align", 7))}
    tcfg = load_config(prediff_default_config, TINY)
    state = {"unet": flax_params_to_torch(build_unet(tcfg), jparams["unet"]),
             "vae": flax_params_to_torch(build_vae(tcfg), jparams["vae"]),
             "align": flax_params_to_torch(build_alignment_model(tcfg), jparams["align"])}
    predictor = PreDiffPredictor(tcfg, params=state, with_alignment=True, device="cpu")
    rs = np.random.RandomState(7)
    y = rs.rand(2, 3, 32, 32, 1).astype(np.float32)
    x_T = rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    avg = np.array([[0.3], [0.7]], np.float32)
    return ld, jparams, predictor, y, x_T, avg


@pytest.mark.parametrize("sampler,guided,k", [("ddpm", True, 1), ("ddpm", True, 2),
                                              ("ddim", False, 1), ("ddim", True, 1),
                                              ("ddim", True, 2)])
def test_chain_matches_jax_sample(pipelines, sampler, guided, k):
    ld, jparams, predictor, y, x_T, avg = pipelines
    common = (dict(sampler="ddim", ddim_steps=4, ddim_eta=0.0) if sampler == "ddim"
              else dict(timesteps=3))
    jguide = tguide = {}
    if guided:
        jguide = dict(use_alignment=True, guidance_every_k=k,
                      alignment_kwargs={"avg_x_gt": jnp.asarray(avg)})
        tguide = dict(use_alignment=True, guidance_every_k=k,
                      alignment_kwargs={"avg_x_gt": torch.from_numpy(avg)})
    want = np.asarray(ld.sample(jparams["unet"], jparams["vae"], jax.random.PRNGKey(0),
                                jnp.asarray(y), align_params=jparams["align"],
                                x_T=jnp.asarray(x_T), temperature=0.0, **common, **jguide))
    got = predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), temperature=0.0,
                              **common, **tguide)
    assert got.shape == want.shape == (2, 2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_guidance_moves_the_forecast(pipelines):
    _, _, predictor, y, x_T, avg = pipelines
    plain = predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), timesteps=3,
                                temperature=0.0)
    guided = predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), timesteps=3,
                                 temperature=0.0, use_alignment=True,
                                 alignment_kwargs={"avg_x_gt": torch.from_numpy(avg)})
    assert (guided - plain).abs().max() > 1e-3


@pytest.mark.parametrize("method,steps,total", [("uniform", 50, 1000), ("uniform", 4, 8),
                                                ("quad", 10, 1000)])
def test_ddim_schedule_matches_jax(method, steps, total):
    ts = schedule.make_ddim_timesteps(method, steps, total)
    np.testing.assert_array_equal(ts, jax_schedule.make_ddim_timesteps(method, steps, total))
    alphacums = np.asarray(jax_schedule.make_gaussian_schedule("linear", total).alphas_cumprod,
                           np.float64)
    ts = np.clip(ts, 0, total - 1)
    for eta in (0.0, 0.5):
        for got, want in zip(schedule.make_ddim_sampling_parameters(alphacums, ts, eta),
                             jax_schedule.make_ddim_sampling_parameters(alphacums, ts, eta)):
            np.testing.assert_array_equal(got, want)


def test_build_pipeline_with_alignment_predicts_on_cpu():
    tcfg = load_config(prediff_default_config, TINY)
    ld = build_pipeline(tcfg, with_alignment=True, device="cpu", seed=0)
    assert ld.alignment is not None and ld.alignment.guide_scale == tcfg.model.align.guide_scale
    assert not any(p.requires_grad for p in ld.alignment.model.parameters())
    predictor = PreDiffPredictor(tcfg, device="cpu", seed=0)
    y = np.random.RandomState(8).rand(1, 3, 32, 32, 1).astype(np.float32)
    out = predictor.predict(y, use_alignment=True, avg_x_gt=np.array([[0.5]], np.float32),
                            ddim_steps=2, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 2, 32, 32, 1) and torch.isfinite(out).all()
    ens = predictor.predict_ensemble(y, num_samples=2, use_alignment=True,
                                     avg_x_gt=np.array([[0.5]], np.float32), timesteps=2,
                                     generator=torch.Generator().manual_seed(0))
    assert ens.shape == (2, 1, 2, 32, 32, 1) and not torch.equal(ens[0], ens[1])
    with pytest.raises(ValueError):
        predictor.predict(y, use_alignment=True)          # no avg_x_gt
