"""The reverse step that a CUDA graph captures, run eagerly on the CPU, and the
cache of captured steps (``prediff_torch/diffusion/graphs.py``).

The step reads t, the DDIM index and its noise from buffers and gathers the
schedule on the device.  Run eagerly, its chain must give the bits of the
chain of Python-number steps that it replaced, at temperature 1 from the
same generator: ``reference_sample`` below is that chain, kept verbatim.
The cache's keys and its parameter-version snapshot need no card."""
import os

import numpy as np
import pytest
import torch

from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.diffusion import core
from prediff_torch.diffusion.graphs import StepGraphCache, launch_counters
from prediff_torch.factory import build_pipeline
from prediff_torch.training.optim import build_optimizer

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite's
    workers share the CPU, and a thread per core in each of them makes such
    tests tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- the chain of Python-number steps the capturable step replaced ------- #
@torch.no_grad()
def reference_p_sample_step(ld, z, t, zc, temperature, generator, y=None, avg_x_gt=None,
                            guidance_every_k=1):
    t_b = torch.full((z.shape[0],), t, dtype=torch.long, device=z.device)
    model_out = ld.unet(z, t_b, zc)
    mean, _, log_var, _ = core.p_mean_variance(
        ld.schedule, model_out, z, t_b, parameterization=ld.parameterization,
        clip_denoised=ld.clip_denoised)
    if avg_x_gt is not None:
        k = int(guidance_every_k)
        if k <= 1:
            mean = mean - torch.exp(0.5 * log_var) * ld._shift(z, t_b, zc, y, avg_x_gt)
        elif t % k == 0:
            shift = ld._shift(z, t_b, zc, y, avg_x_gt)
            mean = mean - torch.exp(0.5 * log_var) * (float(k) * shift)
    if t == 0 or temperature == 0.0:
        return mean
    noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
    return mean + torch.exp(0.5 * log_var) * noise * temperature


@torch.no_grad()
def reference_ddim_step(ld, z, idx, ddim, zc, temperature, generator, clip_x0=False, y=None,
                        avg_x_gt=None, guidance_every_k=1):
    ts, sigmas, alphas, alphas_prev = ddim
    t_b = torch.full((z.shape[0],), int(ts[idx]), dtype=torch.long, device=z.device)
    model_out = ld.unet(z, t_b, zc)
    one = np.float32(1.0)
    a_t, a_prev, sigma = alphas[idx], alphas_prev[idx], sigmas[idx]
    sqrt_a, sqrt_1ma = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
    if ld.parameterization == "eps":
        eps = model_out
        x0_pred = (z - sqrt_1ma * eps) / sqrt_a
    else:
        x0_pred = model_out
        eps = (z - sqrt_a * x0_pred) / sqrt_1ma
    if clip_x0 or ld.clip_denoised:
        x0_pred = torch.clamp(x0_pred, -1.0, 1.0)
    if avg_x_gt is not None:
        k = int(guidance_every_k)
        if k <= 1 or idx % k == 0:
            shift = ld._shift(z, t_b, zc, y, avg_x_gt)
            eps = eps + sqrt_1ma * (float(max(k, 1)) * shift)
        x0_pred = (z - sqrt_1ma * eps) / sqrt_a
    dir_coef = float(np.sqrt(np.maximum(one - a_prev - sigma * sigma, np.float32(0.0))))
    out = float(np.sqrt(a_prev)) * x0_pred + dir_coef * eps
    if sigma != 0.0 and temperature != 0.0:
        noise = torch.randn(z.shape, generator=generator, device=z.device, dtype=z.dtype)
        out = out + float(sigma) * noise * temperature
    return out


@torch.no_grad()
def reference_sample(ld, y, use_alignment=False, avg_x_gt=None, sampler="ddpm", ddim_steps=None,
                     ddim_eta=0.0, ddim_clip_x0=False, guidance_every_k=1, timesteps=None,
                     temperature=1.0, generator=None):
    B = y.shape[0]
    z = torch.randn((B,) + ld.latent_shape, generator=generator, device=ld.device)
    zc = ld.cond_stage_forward(y)
    guide = dict(y=y, avg_x_gt=avg_x_gt if use_alignment else None,
                 guidance_every_k=guidance_every_k)
    total_T = timesteps or ld.num_timesteps
    if sampler == "ddpm":
        for t in range(total_T - 1, -1, -1):
            z = reference_p_sample_step(ld, z, t, zc, temperature, generator, **guide)
    else:
        ddim = ld.ddim_schedule(ddim_steps, total_T, ddim_eta)
        for idx in range(len(ddim[0]) - 1, -1, -1):
            z = reference_ddim_step(ld, z, idx, ddim, zc, temperature, generator, ddim_clip_x0,
                                    **guide)
    return ld.decode_first_stage(z)


# -------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ld():
    return build_pipeline(load_config(prediff_default_config, TINY), with_alignment=True,
                          device="cpu", seed=3)


@pytest.fixture(scope="module")
def context():
    rs = np.random.RandomState(11)
    return (torch.from_numpy(rs.rand(2, 3, 32, 32, 1).astype(np.float32)),
            torch.tensor([[0.3], [0.7]]))


@pytest.mark.parametrize("sampler,guided,k,extra", [
    ("ddpm", False, 1, {}), ("ddpm", True, 1, {}), ("ddpm", True, 2, {}),
    ("ddim", False, 1, dict(ddim_eta=0.5)), ("ddim", True, 1, dict(ddim_eta=0.0)),
    ("ddim", True, 2, dict(ddim_eta=0.5, ddim_clip_x0=True))])
def test_capturable_step_gives_the_bits_of_the_replaced_step(ld, context, sampler, guided, k,
                                                             extra):
    y, avg = context
    kw = dict(sampler=sampler, guidance_every_k=k, **extra,
              **(dict(ddim_steps=3, timesteps=8) if sampler == "ddim" else dict(timesteps=3)))
    want = reference_sample(ld, y, use_alignment=guided, avg_x_gt=avg,
                            generator=torch.Generator().manual_seed(5), **kw)
    got = ld.sample(y, use_alignment=guided, alignment_kwargs={"avg_x_gt": avg},
                    generator=torch.Generator().manual_seed(5), **kw)
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_x0_parameterization_step_gives_the_bits_of_the_replaced_step(ld, context):
    y, avg = context
    ld.parameterization = "x0"
    try:
        kw = dict(sampler="ddim", ddim_steps=2, timesteps=6, ddim_eta=0.5)
        want = reference_sample(ld, y, use_alignment=True, avg_x_gt=avg,
                                generator=torch.Generator().manual_seed(2), **kw)
        got = ld.sample(y, use_alignment=True, alignment_kwargs={"avg_x_gt": avg},
                        generator=torch.Generator().manual_seed(2), **kw)
        ddpm_want = reference_sample(ld, y, timesteps=2,
                                     generator=torch.Generator().manual_seed(4))
        ddpm_got = ld.sample(y, timesteps=2, generator=torch.Generator().manual_seed(4))
    finally:
        ld.parameterization = "eps"
    assert torch.equal(got, want) and torch.equal(ddpm_got, ddpm_want)


def test_one_step_alone_is_the_chains_step(ld, context):
    y, avg = context
    zc = ld.cond_stage_forward(y)
    z = torch.randn((2,) + ld.latent_shape, generator=torch.Generator().manual_seed(1))
    for t, k in ((4, 1), (3, 2), (0, 1)):
        want = reference_p_sample_step(ld, z, t, zc, 1.0, torch.Generator().manual_seed(9),
                                       avg_x_gt=avg, guidance_every_k=k)
        plan = ld._chain_plan("ddpm", t + 1, None, 0.0, False, 1.0, True, k, False, 1)
        bufs = ld._buffers(plan, z, zc, None, avg, None, None)
        bufs.t.fill_(t)
        if plan.draws[0]:
            ld._draw(bufs.noise, torch.Generator().manual_seed(9))
        ld._reverse_step(bufs, plan, bool(plan.guided[0]))
        assert torch.equal(bufs.z, want)


def test_cache_keeps_one_entry_per_key_and_reuses_it(ld):
    cache = StepGraphCache(ld._graph_modules)
    made = []

    def make():
        made.append(1)
        return "plan", "buffers"

    a, new_a = cache.entry(("k", 1), make)
    b, new_b = cache.entry(("k", 1), make)
    c, new_c = cache.entry(("k", 2), make)
    assert (new_a, new_b, new_c) == (True, False, True)
    assert a is b and a is not c and len(cache) == 2 and len(made) == 2
    assert (a.plan, a.buffers, a.graphs) == ("plan", "buffers", {})


def test_version_snapshot_sees_in_place_updates(ld):
    cache = StepGraphCache(ld._graph_modules)
    assert cache.validate() is False
    cache.entry("key", lambda: (None, None))
    assert cache.validate() is False and len(cache) == 1
    w = next(ld.unet.parameters())
    with torch.no_grad():
        w.copy_(w)                                   # copy_ under no_grad bumps _version
    assert cache.validate() is True and len(cache) == 0
    assert cache.validate() is False
    # the port's fused AdamW step bumps the version of every parameter it updates
    p = torch.nn.Parameter(next(ld.alignment.model.parameters()).detach().clone())
    cache = StepGraphCache(lambda: [torch.nn.ParameterList([p])])
    cache.validate()
    cache.entry("key", lambda: (None, None))
    assert build_optimizer([p], lr=1e-3).update([torch.ones_like(p)])
    assert cache.validate() is True and len(cache) == 0


def test_launch_counters_are_every_kernel_wrapper():
    names = {fn.__name__ for fn in launch_counters()}
    assert {"fused_groupnorm_silu", "fused_ffn", "fused_axial_attention",
            "fused_cuboid_attention_layer", "fused_cuboid_attention_grouped",
            "fused_resblock_fwd", "fused_resblock_bwd", "conv3x3x3_forward", "conv3x3x3_dx",
            "fused_groupnorm_silu_bwd_full", "fused_ffn_bwd_dx",
            "fused_axial_attention_bwd_dx"} <= names
    assert all(isinstance(fn.launches, int) for fn in launch_counters())
