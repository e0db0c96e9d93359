"""Cuboid patterns, window masks and routing: the port's pattern registry,
``compute_cuboid_self_attention_mask``, ``masked_softmax`` and the reorder
against the JAX package; the route each layer takes at the full-width
shapes; the factory and the trainer on the non-axial patterns; the weight
bridge both ways for a ``video_swin_1x8`` UNet (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import deep_merge
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.models.patterns import CuboidSelfAttentionPatterns as JaxPatterns
from prediff_tpu.ops import cuboid as jax_cuboid
from prediff_tpu.utils.convert import convert_torch_state_dict
from prediff_torch.config import ConfigDict, load_config, prediff_default_config
from prediff_torch.factory import (build_alignment_model, build_training_pipeline, build_unet)
from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer, attention_route
from prediff_torch.models.patterns import CuboidSelfAttentionPatterns
from prediff_torch.ops import cuboid
from prediff_torch.utils.convert import flatten_tree, flax_params_to_torch

SHAPES = [(13, 16, 16, 256), (13, 8, 8, 512), (6, 16, 16, 128), (6, 8, 8, 256), (5, 4, 4, 16),
          (2, 2, 2, 32), (1, 3, 5, 8)]


def test_registry_has_the_jax_names():
    assert sorted(CuboidSelfAttentionPatterns) == JaxPatterns.list_keys()
    assert len(CuboidSelfAttentionPatterns) == 44


@pytest.mark.parametrize("name", sorted(CuboidSelfAttentionPatterns))
def test_pattern_gives_the_jax_lists(name):
    for shape in SHAPES:
        got = CuboidSelfAttentionPatterns[name](shape)
        want = JaxPatterns.get(name)(shape)
        assert [list(map(tuple, g)) for g in got] == [list(map(tuple, w)) for w in want], shape


# (T, H, W), cuboid, shift, strategy: padded and shifted, local and dilated
MASK_CASES = [
    ((13, 16, 16), (1, 8, 8), (0, 4, 4), ("l", "l", "l")),
    ((5, 6, 6), (2, 4, 4), (1, 2, 2), ("l", "l", "l")),
    ((5, 6, 6), (2, 4, 4), (0, 0, 0), ("l", "l", "l")),
    ((6, 8, 8), (2, 4, 4), (1, 2, 2), ("d", "d", "d")),
    ((5, 6, 7), (2, 3, 2), (0, 0, 0), ("l", "d", "l")),
    ((4, 4, 4), (2, 2, 2), (1, 1, 0), ("l", "l", "d")),
]


@pytest.mark.parametrize("padding_type", ["zeros", "ignore", "nearest"])
@pytest.mark.parametrize("shape,cs,shift,strategy", MASK_CASES)
def test_window_mask_is_bit_equal(shape, cs, shift, strategy, padding_type):
    cs, shift = cuboid.update_cuboid_size_shift_size(shape, cs, shift, strategy)
    want = jax_cuboid.compute_cuboid_self_attention_mask(shape, cs, shift, strategy, padding_type)
    got = cuboid.compute_cuboid_self_attention_mask(shape, cs, shift, strategy, padding_type)
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.bool_ and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_ignore_padding_gives_fully_masked_rows():
    mask = cuboid.compute_cuboid_self_attention_mask((5, 6, 6), (2, 4, 4), (0, 0, 0),
                                                     ("l", "l", "l"), "ignore")
    assert (~mask.any(-1)).any()


@pytest.mark.parametrize("strategy", [("l", "l", "l"), ("d", "l", "d")])
def test_reorder_matches_jax(strategy):
    x = np.random.RandomState(0).randn(2, 4, 6, 8, 3).astype(np.float32)
    want = np.asarray(jax_cuboid.cuboid_reorder(jnp.asarray(x), (2, 3, 4), strategy))
    got = cuboid.cuboid_reorder(torch.from_numpy(x), (2, 3, 4), strategy)
    np.testing.assert_array_equal(got.numpy(), want)
    back = cuboid.cuboid_reorder_reverse(got, (2, 3, 4), strategy, (4, 6, 8))
    np.testing.assert_array_equal(back.numpy(), x)


def test_masked_softmax_matches_jax_with_a_fully_masked_row():
    rs = np.random.RandomState(1)
    s = rs.randn(3, 5, 7).astype(np.float32) * 3
    mask = rs.rand(3, 5, 7) > 0.4
    mask[1, 2] = False
    want = np.asarray(jax_cuboid.masked_softmax(jnp.asarray(s), jnp.asarray(mask)))
    got = cuboid.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[1, 2] == 0).all() and np.isfinite(got).all()
    np.testing.assert_allclose(cuboid.masked_softmax(torch.from_numpy(s), None).numpy(),
                               np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1)), rtol=1e-6)


def _routes(pattern, shape, padding_type="zeros"):
    sizes, strategies, shifts = CuboidSelfAttentionPatterns[pattern](shape)
    return [attention_route(shape[:3], cs, ss, st, padding_type)
            for cs, st, ss in zip(sizes, strategies, shifts)]


# the routing table of the four full-width attention shapes (UNet 13x16x16x256,
# 13x8x8x512; alignment net 6x16x16x128, 6x8x8x256), heads 4, padding "zeros"
ROUTE_TABLE = {
    "video_swin_1x8": [["v4", "grouped_masked"], ["v4", "v4"], ["v4", "grouped_masked"],
                       ["v4", "v4"]],
    "video_swin_2x8": [["grouped", "grouped_masked"], ["grouped", "grouped_masked"],
                       ["v4", "grouped_masked"], ["v4", "grouped_masked"]],
    "divided_st": [["axial", "v4"]] * 4,
    "spatial_lg_v1": [["axial", "v4", "v4"]] * 4,
    "axial": [["axial"] * 3] * 4,
    "full": [["grouped"], ["grouped"], ["grouped"], ["grouped"]],
}


@pytest.mark.parametrize("pattern", sorted(ROUTE_TABLE))
def test_routes_at_full_width(pattern):
    shapes = [(13, 16, 16, 256), (13, 8, 8, 512), (6, 16, 16, 128), (6, 8, 8, 256)]
    assert [_routes(pattern, s) for s in shapes] == ROUTE_TABLE[pattern]


def _jax_geometric_route(shape, cs, ss, st, padding_type):
    """The JAX layer's decision, without its TPU-only gates (VMEM budget,
    dim % 128, G * vol % 8), from the JAX package's own functions."""
    from prediff_tpu.ops.pallas_attention import V4_MAX_ROWS
    T, H, W = shape
    cs, ss = jax_cuboid.update_cuboid_size_shift_size((T, H, W), cs, ss, st)
    mask = jax_cuboid.compute_cuboid_self_attention_mask((T, H, W), cs, tuple(ss), tuple(st),
                                                         padding_type)
    pads = [(c - n % c) % c for n, c in zip((T, H, W), cs)]
    if any(pads) or any(ss) or mask is not None:
        return "grouped_masked" if mask is not None else "grouped"
    for ax in range(3):
        if cs[ax] == (T, H, W)[ax] and all(cs[o] == 1 for o in range(3) if o != ax):
            return "axial"
    return "v4" if np.prod(cs) <= V4_MAX_ROWS else "grouped"


@pytest.mark.parametrize("padding_type", ["zeros", "ignore"])
def test_every_pattern_routes_as_the_jax_layer(padding_type):
    for name in sorted(CuboidSelfAttentionPatterns):
        for shape in SHAPES:
            sizes, strategies, shifts = JaxPatterns.get(name)(shape)
            for cs, st, ss in zip(sizes, strategies, shifts):
                want = _jax_geometric_route(shape[:3], cs, ss, st, padding_type)
                assert attention_route(shape[:3], cs, ss, st, padding_type) == want, (name, shape)


def _swin_cfg(pattern="video_swin_1x8"):
    cfg = load_config(prediff_default_config)
    return ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"self_pattern": pattern},
        "align": {"model_args": {"block_attn_patterns": pattern}}}}))


def test_factory_builds_the_swin_configuration_and_refuses_what_is_not_ported():
    cfg = _swin_cfg()
    unet, align = build_unet(cfg), build_alignment_model(cfg)
    layers = [m for m in unet.modules() if isinstance(m, CuboidSelfAttentionLayer)]
    assert len(layers) == 32 and {m.padding_type for m in layers} == {"zeros"}
    assert tuple(unet.down_self_blocks[0][0].attn_l[1].shift_size) == (0, 4, 4)
    assert tuple(align.down_self_blocks[0][0].attn_l[0].cuboid_size) == (1, 8, 8)
    ld = build_training_pipeline(cfg, device="cpu")       # trains since PERF.md rows 13b, 15e
    assert ld.unet.training and all(p.requires_grad for p in ld.unet.parameters())
    assert ld.alignment is None and not ld.vae.training
    gv = _swin_cfg()
    gv.model.latent_model["num_global_vectors"] = 8          # global vectors build
    assert tuple(build_unet(gv).init_global_vectors.shape) == (8, 256)
    gv.model.latent_model["downsample_type"] = "conv"        # the JAX UNet asserts patch_merge
    with pytest.raises(NotImplementedError, match="downsample_type"):
        build_unet(gv)
    with pytest.raises(ValueError, match="not registered"):
        build_unet(_swin_cfg("video_swin_3x3"))


def test_a_non_axial_layer_refuses_training_mode():
    """The name dates from when training mode refused every route but the
    axial one.  Now each route trains: at rates 0 training mode is the eval
    function, with dropout the call needs the forward's DropoutStream, and
    attention-weight dropout sends a grouped window to the einsum route."""
    from prediff_torch.ops.dropout import DropoutStream
    x = torch.randn(1, 2, 4, 4, 64)   # a width the v4 kernels take
    for cs, shift, route in (((1, 2, 2), (0, 1, 1), "grouped_masked"), ((1, 2, 2), (0, 0, 0), "v4")):
        layer = CuboidSelfAttentionLayer(64, 2, cs, shift, padding_type="zeros")
        with torch.no_grad():
            assert torch.equal(layer.train()(x), layer.eval()(x))
        assert layer.train().route(x.shape) == layer.eval().route(x.shape) == route
        layer = CuboidSelfAttentionLayer(64, 2, cs, shift, padding_type="zeros", attn_drop=0.1,
                                         proj_drop=0.1).train()
        with pytest.raises(ValueError, match="DropoutStream"):
            layer(x)
        stream = DropoutStream(3)
        out = layer(x, stream)
        assert stream.site == 1 and torch.isfinite(out).all()
        assert layer.route(x.shape) == ("v4" if route == "v4" else "grouped_einsum")
        assert layer.eval().route(x.shape) == route


def test_bridge_round_trip_of_a_video_swin_unet():
    over = {"model": {"latent_model": dict(input_shape=[7, 8, 8, 8], target_shape=[6, 8, 8, 8],
                                           base_units=16, depth=[1, 1],
                                           self_pattern="video_swin_1x8")}}
    jcfg = jax_load_config(jax_default_config)
    jcfg = type(jcfg).wrap(deep_merge(jcfg.to_dict(), over))
    tcfg = load_config(prediff_default_config)
    tcfg = type(tcfg).wrap(deep_merge(tcfg.to_dict(), over))
    x = jnp.zeros((1, 6, 8, 8, 8))
    params = jax_build_unet(jcfg).init(jax.random.PRNGKey(0), x, jnp.array([1]),
                                       jnp.zeros((1, 7, 8, 8, 8)))["params"]
    params = randomize_flax(params, seed=3)
    tunet = build_unet(tcfg)
    sd = flax_params_to_torch(tunet, params)
    assert tuple(sd["down_self_blocks.0.0.attn_l.0.relative_position_bias_table"].shape) == (225, 4)
    back = flatten_tree(convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, params))
    flat = flatten_tree(params)
    assert sorted(back) == sorted(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf), err_msg="/".join(path))
