"""The arguments of ``sample`` beyond the forecast itself, held to the JAX
package's ``LatentDiffusion.sample`` on configs/tiny_smoke.yaml with the same
randomized weights, x_T and temperature 0 (CPU): the inpainting ``mask`` /
``x0``, ``return_intermediates`` (``log_every_t`` 1: three segments),
``return_decoded=False`` and ``sample_ensemble`` with them.

The masked step's second noise comes from each package's own generator, so
the test injects one array on both sides: ``jax.random.normal`` is patched
inside the test (at temperature 0 the step's own noise is multiplied by 0),
and the port's draw ``LatentDiffusion._draw``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.factory import build_alignment_model, build_unet, build_vae
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 on both sides, as tests/test_torch_chain.py
ATOL = RTOL = 1e-4
LATENT = (2, 4, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite's
    workers share the CPU, and a thread per core in each of them makes such
    tests tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    ld.log_every_t = predictor.ld.log_every_t = 1
    rs = np.random.RandomState(17)
    data = dict(y=rs.rand(2, 3, 32, 32, 1).astype(np.float32),
                x_T=rs.randn(4, *LATENT).astype(np.float32),
                x0=rs.randn(2, *LATENT).astype(np.float32),
                mask=(rs.rand(2, *LATENT) > 0.5).astype(np.float32),
                noise2=rs.randn(4, *LATENT).astype(np.float32))
    return ld, jparams, predictor, data


@pytest.fixture
def injected(monkeypatch, pipelines):
    """The same second noise on both sides: ``n`` rows of ``noise2``."""
    _, _, predictor, data = pipelines
    normal = jax.random.normal

    def patch(n):
        noise = data["noise2"][:n]

        def fake(key, shape=(), dtype=jnp.float32):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise, dtype)
            return normal(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", fake)
        monkeypatch.setattr(predictor.ld, "_draw",
                            lambda buf, generator: buf.copy_(torch.from_numpy(noise)))

    return patch


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mask_intermediates_and_latents_match_jax(pipelines, injected):
    ld, jparams, predictor, d = pipelines
    injected(2)
    want, want_inter = ld.sample(
        jparams["unet"], jparams["vae"], jax.random.PRNGKey(0), jnp.asarray(d["y"]),
        x_T=jnp.asarray(d["x_T"][:2]), timesteps=3, temperature=0.0,
        mask=jnp.asarray(d["mask"]), x0=jnp.asarray(d["x0"]), return_intermediates=True,
        return_decoded=False)
    y, x_T = torch.from_numpy(d["y"]), torch.from_numpy(d["x_T"][:2])
    kw = dict(x_T=x_T, timesteps=3, temperature=0.0, mask=torch.from_numpy(d["mask"]),
              x0=torch.from_numpy(d["x0"]), return_intermediates=True)
    got, inter = predictor.ld.sample(y, return_decoded=False, **kw)
    assert got.shape == (2,) + LATENT and len(inter) == len(want_inter) == 3
    _close(got, want)
    for g, w in zip(inter, want_inter):
        _close(g, w)
    # decoded: the decode of each segment's end (the decode is held to JAX in
    # tests/test_torch_chain.py)
    out, dec_inter = predictor.ld.sample(y, **kw)
    assert out.shape == (2, 2, 32, 32, 1) and len(dec_inter) == 3
    for g, z in zip([out] + dec_inter, [got] + inter):
        torch.testing.assert_close(g, predictor.ld.decode_first_stage(z), rtol=0, atol=0)
    unmasked = predictor.ld.sample(y, x_T=x_T, timesteps=3, temperature=0.0,
                                   return_decoded=False)
    assert (unmasked - got).abs().max() > 1e-3       # the mask moved the forecast
    one = predictor.ld.sample(y, x_T=x_T, timesteps=1, temperature=0.0,
                              return_intermediates=True, return_decoded=False)
    assert one[1] is None                            # one segment: no intermediates, as JAX


def test_ensemble_with_mask_and_latents_matches_jax(pipelines, injected):
    ld, jparams, predictor, d = pipelines
    injected(4)
    mask, x0 = d["mask"][:1], d["x0"][:1]            # one row, broadcast over the members
    want = ld.sample_ensemble(
        jparams["unet"], jparams["vae"], jax.random.PRNGKey(0), jnp.asarray(d["y"]), 2,
        x_T=jnp.asarray(d["x_T"]), timesteps=2, temperature=0.0, mask=jnp.asarray(mask),
        x0=jnp.asarray(x0), return_decoded=False)
    kw = dict(x_T=torch.from_numpy(d["x_T"]), timesteps=2, temperature=0.0,
              mask=torch.from_numpy(mask), x0=torch.from_numpy(x0))
    got = predictor.ld.sample_ensemble(torch.from_numpy(d["y"]), 2, return_decoded=False, **kw)
    assert got.shape == (2, 2) + LATENT
    _close(got, want)
    # intermediates fold like the output
    out, inter = predictor.ld.sample_ensemble(torch.from_numpy(d["y"]), 2,
                                              return_intermediates=True, **kw)
    assert out.shape == (2, 2, 2, 32, 32, 1) and len(inter) == 2
    assert all(i.shape == out.shape for i in inter)
    torch.testing.assert_close(inter[-1], out, rtol=0, atol=0)


def test_ddim_ignores_the_mask_and_refusals(pipelines):
    _, _, predictor, d = pipelines
    kw = dict(x_T=torch.from_numpy(d["x_T"][:2]), sampler="ddim", ddim_steps=2, timesteps=4,
              temperature=0.0, return_decoded=False)
    y = torch.from_numpy(d["y"])
    plain = predictor.ld.sample(y, **kw)
    masked = predictor.ld.sample(y, mask=torch.from_numpy(d["mask"]),
                                 x0=torch.from_numpy(d["x0"]), **kw)
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)
    # with step noise (eta > 0) the mask draws nothing either: the same seed, the same forecast
    noisy = dict(kw, temperature=1.0, ddim_eta=0.5)
    plain = predictor.ld.sample(y, generator=torch.Generator().manual_seed(3), **noisy)
    masked = predictor.ld.sample(y, mask=torch.from_numpy(d["mask"]),
                                 x0=torch.from_numpy(d["x0"]),
                                 generator=torch.Generator().manual_seed(3), **noisy)
    torch.testing.assert_close(masked, plain, rtol=0, atol=0)
    # compute_dtype takes the floating dtypes the JAX package names, and no other
    with pytest.raises(ValueError, match="compute_dtype"):
        predictor.ld.sample(y, compute_dtype="int8", **kw)
    assert predictor.ld.sample(y, compute_dtype="bfloat16", **kw).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        predictor.ld.sample(y, mask=torch.from_numpy(d["mask"]), **kw)
    cpu = PreDiffPredictor(predictor.cfg, device="cpu", compute_dtype="bfloat16")
    out = cpu.predict(d["y"], timesteps=1)   # the decode stays f32
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_alignment_compute_dtype_auto_is_float32():
    """Off a TPU the JAX package resolves "auto" to float32; so does the port."""
    ka = KnowledgeAlignment(torch.nn.Identity(), compute_dtype="auto")
    assert ka.compute_dtype == "float32"
    ka = KnowledgeAlignment(torch.nn.Identity(), compute_dtype=torch.bfloat16)
    assert ka.compute_dtype == "bfloat16" and ka.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        KnowledgeAlignment(torch.nn.Identity(), compute_dtype="int8")
