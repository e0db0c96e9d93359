"""The unguided DDPM chain end to end (encode, 3 reverse steps, decode) on
configs/tiny_smoke.yaml: the port against ``LatentDiffusion.sample`` with
the same randomized weights, the same x_T and temperature 0 (CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet, build_vae
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 on both sides, three UNet steps plus the VAE
ATOL = RTOL = 1e-4



def test_ddpm_chain_matches_jax_sample():
    jcfg = jax_load_config(jax_default_config, TINY)
    ld, params = jax_build_pipeline(jcfg, with_alignment=False)
    unet_p = randomize_flax(params["unet"], 5)
    vae_p = randomize_flax(params["vae"], 6)
    rs = np.random.RandomState(7)
    y = rs.rand(2, 3, 32, 32, 1).astype(np.float32)
    x_T = rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    want = np.asarray(ld.sample(unet_p, vae_p, jax.random.PRNGKey(0), jnp.asarray(y),
                                x_T=jnp.asarray(x_T), timesteps=3, temperature=0.0))

    tcfg = load_config(prediff_default_config, TINY)
    state = {"unet": flax_params_to_torch(build_unet(tcfg), unet_p),
             "vae": flax_params_to_torch(build_vae(tcfg), vae_p)}
    predictor = PreDiffPredictor(tcfg, params=state, device="cpu")
    got = predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), timesteps=3,
                              temperature=0.0).numpy()
    assert got.shape == want.shape == (2, 2, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predict_runs_the_chain_on_cpu():
    tcfg = load_config(prediff_default_config, TINY)
    predictor = PreDiffPredictor(tcfg, device="cpu", seed=0)
    y = np.random.RandomState(8).rand(1, 3, 32, 32, 1).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    a = predictor.predict(y, timesteps=2, generator=gen)
    b = predictor.predict(y, timesteps=2, generator=torch.Generator().manual_seed(0))
    assert a.shape == (1, 2, 32, 32, 1) and torch.isfinite(a).all()
    assert torch.equal(a, b)
