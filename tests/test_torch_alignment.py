"""The knowledge-alignment net and the guidance shift: the port against the
flax ``NoisyCuboidTransformerEncoder`` and ``KnowledgeAlignment`` with every
leaf randomized and carried over by the weight bridge; the bridge's Conv1d
leaves both ways (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.diffusion.knowledge_alignment import KnowledgeAlignment as JaxAlignment
from prediff_tpu.models.alignment import NoisyCuboidTransformerEncoder as JaxEncoder
from prediff_tpu.utils.convert import convert_torch_state_dict
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.models.alignment import NoisyCuboidTransformerEncoder
from prediff_torch.utils.convert import flatten_tree, flax_params_to_torch, torch_key_to_flax_path

# f32 end to end on both sides; sums run in another order
ATOL = RTOL = 1e-4

# the alignment net of tests/test_guidance_kernels.py: both resblocks at the
# fused widths (128, 256), three axial layers per stage
KW = dict(input_shape=(2, 8, 8, 64), out_channels=1, base_units=128, depth=[1, 1], downsample=2,
          block_attn_patterns="axial", num_heads=4, padding_type="zeros", out_len=2)


@pytest.fixture(scope="module")
def nets():
    jnet = JaxEncoder(attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0, ffn_activation="gelu",
                      readout_seq=True, **KW)
    rs = np.random.RandomState(1)
    zt = (rs.randn(2, 2, 8, 8, 64) * 0.5).astype(np.float32)
    t = np.array([3, 7], np.int32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(zt), jnp.asarray(t))["params"]
    params = randomize_flax(params, seed=2)
    tnet = NoisyCuboidTransformerEncoder(**KW).eval().requires_grad_(False)
    tnet.load_state_dict(flax_params_to_torch(tnet, params))
    return jnet, params, tnet, zt, t


def test_encoder_forward_matches_flax(nets):
    jnet, params, tnet, zt, t = nets
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(zt), jnp.asarray(t)))
    with torch.no_grad():
        got = tnet(torch.from_numpy(zt), torch.from_numpy(t).long()).numpy()
    assert got.shape == want.shape == (2, 2, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("guide_scale", [1.0, 50.0])
def test_mean_shift_matches_flax(nets, guide_scale):
    jnet, params, tnet, zt, t = nets
    avg = np.array([[0.4], [0.6]], np.float32)
    want = np.asarray(JaxAlignment(params=params, guide_scale=guide_scale,
                                   apply_fn=jnet.apply).get_mean_shift(
        jnp.asarray(zt), jnp.asarray(t), jnp.asarray(avg)))
    ka = KnowledgeAlignment(tnet, guide_scale=guide_scale)
    with torch.no_grad():   # the shift takes its gradient whatever the grad mode
        got = ka.get_mean_shift(torch.from_numpy(zt), torch.from_numpy(t).long(),
                                torch.from_numpy(avg)).numpy()
    assert got.shape == zt.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=RTOL, atol=ATOL)
    energy = float(ka.alignment_energy(torch.from_numpy(zt), torch.from_numpy(t).long(),
                                       torch.from_numpy(avg)))
    want_e = float(JaxAlignment(params=params, apply_fn=jnet.apply).alignment_energy(
        jnp.asarray(zt), jnp.asarray(t), jnp.asarray(avg)))
    assert abs(energy - want_e) <= RTOL * abs(want_e)


def test_bridge_covers_every_alignment_leaf_once(nets):
    _, params, tnet, _, _ = nets
    flat = flatten_tree(params)
    taken = []
    for key in tnet.state_dict():
        base = torch_key_to_flax_path(key)
        leaves = ("kernel", "scale", "embedding") if base[-1] == "weight" else (base[-1],)
        hits = [base[:-1] + (leaf,) for leaf in leaves if base[:-1] + (leaf,) in flat]
        assert len(hits) == 1, key
        taken.append(hits[0])
    assert sorted(taken) == sorted(flat)
    assert len(set(taken)) == len(taken)
    assert flat[("out_2", "qkv_proj", "kernel")].ndim == 3   # the Conv1d leaves


def test_bridge_round_trips_the_flax_tree(nets):
    """flax -> port state_dict -> flax (the JAX package's converter) is exact."""
    _, params, tnet, _, _ = nets
    sd = flax_params_to_torch(tnet, params)
    assert tuple(sd["out.2.qkv_proj.weight"].shape) == (768, 256, 1)
    back = flatten_tree(convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, params))
    flat = flatten_tree(params)
    assert sorted(back) == sorted(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg="/".join(path))


def test_alignment_rejects_what_is_not_ported():
    # bfloat16 guidance is ported (tests/test_torch_bf16_guidance.py); other names are refused
    assert KnowledgeAlignment(torch.nn.Identity(), compute_dtype="bfloat16").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        KnowledgeAlignment(torch.nn.Identity(), compute_dtype="int8")
