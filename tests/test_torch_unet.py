"""UNet denoiser: the port against the flax UNet with every leaf randomized
and carried over by the weight bridge (CPU, small config)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet
from prediff_torch.utils.convert import flatten_tree, flax_params_to_torch, torch_key_to_flax_path

# f32 end to end on both sides; sums run in another order (einsum vs matmul)
ATOL = RTOL = 1e-4

SMALL = dict(input_shape=[7, 8, 8, 8], target_shape=[6, 8, 8, 8], base_units=16, num_heads=4,
             depth=[2, 2], attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0)


def randomize_flax(params, seed):
    """Every leaf random: v1 init zero-fills ffn_2, proj and out_layers_3,
    which would make a comparison pass trivially."""
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rs.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, params)


def _cfgs():
    over = {"model": {"latent_model": SMALL}}
    from prediff_tpu.config import deep_merge
    jcfg = jax_load_config(jax_default_config)
    jcfg = type(jcfg).wrap(deep_merge(jcfg.to_dict(), over))
    tcfg = load_config(prediff_default_config)
    tcfg = type(tcfg).wrap(deep_merge(tcfg.to_dict(), over))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    junet = jax_build_unet(jcfg)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 6, 8, 8, 8).astype(np.float32)
    cond = rs.randn(2, 7, 8, 8, 8).astype(np.float32)
    t = np.array([3, 777], dtype=np.int32)
    params = junet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                        jnp.asarray(cond))["params"]
    params = randomize_flax(params, seed=1)
    tunet = build_unet(tcfg).eval()
    tunet.load_state_dict(flax_params_to_torch(tunet, params))
    return junet, params, tunet, (x, t, cond)


def test_unet_forward_matches_flax(models):
    junet, params, tunet, (x, t, cond) = models
    want = np.asarray(junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    with torch.no_grad():
        got = tunet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond)).numpy()
    assert got.shape == want.shape == (2, 6, 8, 8, 8)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_bridge_covers_every_parameter_once(models):
    _, params, tunet, _ = models
    flat = flatten_tree(params)
    sd = tunet.state_dict()
    taken = []
    for key in sd:
        base = torch_key_to_flax_path(key)
        leaves = ("kernel", "scale", "embedding") if base[-1] == "weight" else (base[-1],)
        hits = [base[:-1] + (leaf,) for leaf in leaves if base[:-1] + (leaf,) in flat]
        assert len(hits) == 1, key
        taken.append(hits[0])
    assert sorted(taken) == sorted(flat)
    assert len(set(taken)) == len(taken)
    # the time block is one module per stage, called depth times, as in flax
    assert sum(1 for k in sd if k.startswith("down_time_embed_blocks.") and k.endswith("in_layers.2.weight")) == 2


def test_bridge_rejects_a_missing_leaf(models):
    _, params, tunet, _ = models
    broken = dict(params)
    broken.pop("final_proj")
    with pytest.raises(ValueError):
        flax_params_to_torch(tunet, broken)
