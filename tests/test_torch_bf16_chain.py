"""``compute_dtype="bfloat16"`` of the chain and ``first_stage_dtype`` of the
encode, held to the JAX package on configs/tiny_smoke.yaml with the same
randomized weights, x_T and temperature 0 (CPU).

The chain rounds its carry and the context latent to the compute dtype at
each step boundary and computes each step in f32 from the rounded carry (the
denoiser's f32 parameters promote it, in flax as in the port).  Held: the
latent output in bf16 within rel-L2 1e-2 of JAX's bf16 chain, and closer to
it than a quarter of JAX's own bf16-against-f32 difference (the rounding
points are JAX's: elsewhere the port's chain would drift by about that
difference); the decoded output within rel-L2 2e-2.  8 DDPM steps, 4 DDIM
steps at eta 0, a masked DDPM chain (the mask's second noise injected on both
sides, in f32 as JAX draws it) and a guided chain with carry and guidance in
bf16.  ``first_stage_dtype: bfloat16`` encodes on a bf16 copy of the encoder
and the frames and returns f32 moments within rel-L2 2e-2 of the f32 encode
(JAX's) and within 4e-2 of JAX's bf16 encode, which rounds elsewhere; "auto"
and "float32" are the f32 encode bit for bit; "int8" raises."""
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
from prediff_torch.factory import build_alignment_model, build_pipeline, build_unet, build_vae
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
LATENT_TOL, DECODED_TOL, MOMENTS_TOL = 1e-2, 2e-2, 2e-2
ROUNDING_SHARE = 0.25   # |port16 - jax16| <= this share of |jax16 - jax32|
LATENT = (2, 4, 4, 8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
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
    tcfg.model.align.compute_dtype = "bfloat16"
    port = build_pipeline(tcfg, with_alignment=True, device="cpu", params=state)
    ld.alignment = ld.alignment.replace(compute_dtype="bfloat16")
    rs = np.random.RandomState(23)
    data = dict(y=rs.rand(2, 3, 32, 32, 1).astype(np.float32),
                x_T=rs.randn(2, *LATENT).astype(np.float32),
                x0=rs.randn(2, *LATENT).astype(np.float32),
                mask=(rs.rand(2, *LATENT) > 0.5).astype(np.float32),
                noise2=rs.randn(2, *LATENT).astype(np.float32),
                frames=rs.rand(5, 32, 32, 1).astype(np.float32))
    return ld, jparams, port, tcfg, state, data


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


CHAINS = {
    "ddpm": dict(timesteps=8),
    "ddim": dict(timesteps=8, sampler="ddim", ddim_steps=4, ddim_eta=0.0),
    "masked": dict(timesteps=4, mask=True),
    "guided": dict(timesteps=3, use_alignment=True),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_bf16_chain_matches_jax(pipelines, chain, monkeypatch):
    ld, jparams, port, _, _, d = pipelines
    kw = dict(CHAINS[chain])
    jkw, tkw = {}, {}
    if kw.pop("mask", False):
        noise = d["noise2"]
        normal = jax.random.normal

        def fake(key, shape=(), dtype=jnp.float32):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise, dtype)
            return normal(key, shape, dtype)

        monkeypatch.setattr(jax.random, "normal", fake)
        monkeypatch.setattr(port, "_draw", lambda buf, generator: buf.copy_(torch.from_numpy(noise)))
        jkw = dict(mask=jnp.asarray(d["mask"]), x0=jnp.asarray(d["x0"]))
        tkw = dict(mask=torch.from_numpy(d["mask"]), x0=torch.from_numpy(d["x0"]))
    if kw.get("use_alignment"):
        jkw["alignment_kwargs"] = {"avg_x_gt": jnp.asarray([[0.4], [0.6]], jnp.float32)}
        tkw["alignment_kwargs"] = {"avg_x_gt": torch.tensor([[0.4], [0.6]])}
        jkw["align_params"] = jparams["align"]
    y = d["y"]
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[("jax", dtype, False)] = ld.sample(
            jparams["unet"], jparams["vae"], jax.random.PRNGKey(0), jnp.asarray(y),
            x_T=jnp.asarray(d["x_T"]), temperature=0.0, return_decoded=False,
            compute_dtype=dtype, **kw, **jkw)
    # JAX's decode of its bf16 latent, as its chain ends (z / scale in bf16, the f32 VAE)
    out[("jax", "bfloat16", True)] = ld.decode_first_stage(jparams["vae"],
                                                           out[("jax", "bfloat16", False)])
    for decoded in (False, True):
        out[("port", decoded)] = port.sample(torch.from_numpy(y), x_T=torch.from_numpy(d["x_T"]),
                                             temperature=0.0, return_decoded=decoded,
                                             compute_dtype="bfloat16", **kw, **tkw)
    latent = out[("port", False)]
    assert latent.dtype == torch.bfloat16 and out[("jax", "bfloat16", False)].dtype == jnp.bfloat16
    assert out[("port", True)].dtype == torch.float32
    jax16, jax32 = _f32(out[("jax", "bfloat16", False)]), _f32(out[("jax", "float32", False)])
    got = _f32(latent)
    assert _rel(got, jax16) <= LATENT_TOL
    assert np.linalg.norm(got - jax16) <= ROUNDING_SHARE * np.linalg.norm(jax16 - jax32)
    assert _rel(_f32(out[("port", True)]), out[("jax", "bfloat16", True)]) <= DECODED_TOL


def test_first_stage_dtype_matches_jax(pipelines):
    ld, jparams, port, tcfg, state, d = pipelines
    frames = d["frames"]
    f32 = port.first_stage_moments(torch.from_numpy(frames))
    for name in ("auto", "float32"):
        tcfg.model.diffusion.first_stage_dtype = name
        other = build_pipeline(tcfg, device="cpu", params=state)
        assert other.first_stage_dtype == torch.float32
        torch.testing.assert_close(other.first_stage_moments(torch.from_numpy(frames)), f32,
                                   rtol=0, atol=0)
    tcfg.model.diffusion.first_stage_dtype = "bfloat16"
    bf = build_pipeline(tcfg, device="cpu", params=state)
    got = bf.first_stage_moments(torch.from_numpy(frames))
    exact = ld.first_stage_moments(jparams["vae"], jnp.asarray(frames))
    ld.first_stage_dtype = "bfloat16"
    try:
        want = ld.first_stage_moments(jparams["vae"], jnp.asarray(frames))
    finally:
        ld.first_stage_dtype = "auto"
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert not torch.equal(got, f32)   # the encode did run in bf16
    # Each bf16 encode lies within MOMENTS_TOL of the f32 function (JAX's f32
    # moments); the two round at other points (XLA rounds a conv and its bias
    # add apart, torch's conv adds the bias before it rounds), so they are held
    # to each other at the sum of those two distances.
    assert _rel(got.numpy(), exact) <= MOMENTS_TOL
    assert _rel(want, exact) <= 2 * MOMENTS_TOL
    assert _rel(got.numpy(), want) <= 2 * MOMENTS_TOL
    # the encoder's bf16 copy follows its parameters: one copy per version
    copy = bf._encoder.get()
    assert all(p.dtype == torch.bfloat16 for p in copy.parameters())
    with torch.no_grad():
        bf.vae.encoder.conv_in.weight.mul_(2.0)
    assert bf._encoder.get() is copy
    torch.testing.assert_close(copy.encoder.conv_in.weight,
                               bf.vae.encoder.conv_in.weight.to(torch.bfloat16), rtol=0, atol=0)
    tcfg.model.diffusion.first_stage_dtype = "int8"
    with pytest.raises(ValueError, match="first_stage_dtype"):
        build_pipeline(tcfg, device="cpu", params=state)
    tcfg.model.diffusion.first_stage_dtype = "auto"
