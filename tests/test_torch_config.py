"""The port's config tree, schedule and DDPM maths against the JAX package;
the import guard; entry points refuse to fall back to the CPU (CPU)."""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu import config as jax_config
from prediff_tpu.diffusion import core as jax_core
from prediff_tpu.diffusion import schedule as jax_schedule
from prediff_tpu.utils import convert as jax_convert
from prediff_torch import config
from prediff_torch.diffusion import core, schedule
from prediff_torch.utils import convert
from prediff_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("default_fn", ["prediff_default_config", "vae_training_default_config",
                                        "alignment_default_config"])
@pytest.mark.parametrize("yaml_name", [None, "tiny_smoke.yaml"])
def test_config_tree_equals_jax(default_fn, yaml_name):
    path = os.path.join(REPO, "configs", yaml_name) if yaml_name else None
    ours = config.load_config(getattr(config, default_fn), path).to_dict()
    theirs = jax_config.load_config(getattr(jax_config, default_fn), path).to_dict()
    assert ours == theirs


def _port_files():
    root = os.path.join(REPO, "prediff_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = ("jax", "flax", "prediff_tpu", "jaxlib")
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path}: {n}" for n in names if n.split(".")[0] in banned]
    assert not offenders, offenders
    assert len(list(_port_files())) > 20


@pytest.mark.parametrize("beta_schedule", ["linear", "cosine"])
def test_schedule_matches_jax(beta_schedule):
    ours = schedule.make_gaussian_schedule(beta_schedule, timesteps=1000)
    theirs = jax_schedule.make_gaussian_schedule(beta_schedule, timesteps=1000)
    for name in ("betas", "alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "lvlb_weights"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
                                      err_msg=name)
    assert ours.num_timesteps == theirs.num_timesteps


def test_core_matches_jax():
    ours = schedule.make_gaussian_schedule("linear", timesteps=1000)
    theirs = jax_schedule.make_gaussian_schedule("linear", timesteps=1000)
    rs = np.random.RandomState(0)
    z = rs.randn(3, 2, 4, 4, 8).astype(np.float32)
    eps = rs.randn(*z.shape).astype(np.float32)
    t = np.array([0, 99, 999], dtype=np.int64)
    got = core.p_mean_variance(ours, torch.from_numpy(eps), torch.from_numpy(z), torch.from_numpy(t))
    want = jax_core.p_mean_variance(theirs, jnp.asarray(eps), jnp.asarray(z), jnp.asarray(t))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    got_q = core.q_sample(ours, torch.from_numpy(z), torch.from_numpy(t), torch.from_numpy(eps))
    want_q = jax_core.q_sample(theirs, jnp.asarray(z), jnp.asarray(t), jnp.asarray(eps))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), rtol=1e-6, atol=1e-6)


def test_key_mapping_matches_jax():
    for key in ("down_self_blocks.0.1.attn_l.0.qkv.weight", "encoder.down_blocks.2.resnets.0.conv1.bias",
                "time_embed.layer.0.weight", "final_proj.bias"):
        assert convert.torch_key_to_flax_path(key) == jax_convert.torch_key_to_flax_path(key)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_with_alignment_builds_and_predicts():
    from prediff_torch.factory import build_pipeline

    cfg = config.load_config(config.prediff_default_config, os.path.join(REPO, "configs", "tiny_smoke.yaml"))
    ld = build_pipeline(cfg, with_alignment=True, device="cpu")
    y = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 32, 32, 1).astype(np.float32))
    out = ld.sample(y, use_alignment=True, alignment_kwargs={"avg_x_gt": torch.tensor([[0.5]])},
                    timesteps=2, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 2, 32, 32, 1) and torch.isfinite(out).all()
    with pytest.raises(ValueError):   # guidance without the alignment net
        build_pipeline(cfg, device="cpu").sample(y, use_alignment=True,
                                                 alignment_kwargs={"avg_x_gt": torch.tensor([[0.5]])})
