"""The model variants the JAX package builds from its configuration, the
port against the JAX package on the CPU: every activation name, the gated
FFN, the "t+hw" position embedding, the scale-shift time block, the cuboid
layer without a relative bias or a final projection and with global vectors
(``padding_type`` "ignore" and "zeros", with and without the global self
attention and the separate global nets, ``global_dim_ratio`` 2), a small
UNet with global vectors and a small alignment net with hierarchical
position embeddings, one FFN after all attentions, global vectors and the
pooled readout: forward, every gradient, the guidance shift, and the weight
bridge both ways.  Every leaf is randomized by the port's
``init_params_(randomize=True)`` (v1 init zero-fills ``ffn_2``, ``proj`` and
``out_layers_3``) and carried to the JAX module by the bridge, whose tree must
have the leaves and shapes of the JAX module's own init (``jax.eval_shape``:
nothing of the init is compiled); the JAX side is one compiled function a
test.  The init modes: the port's against the JAX initializers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from prediff_tpu.config import deep_merge as jax_deep_merge
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.diffusion.knowledge_alignment import KnowledgeAlignment as JaxAlignment
from prediff_tpu.factory import build_alignment_model as jax_build_alignment_model
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.models import cuboid_attention as jca
from prediff_tpu.models import init as jinit
from prediff_tpu.models import layers as jl
from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.factory import build_alignment_model, build_unet
from prediff_torch.models import cuboid_attention as tca
from prediff_torch.models import layers as tl
from prediff_torch.models.init import init_params_, with_init
from prediff_torch.utils.convert import flax_params_to_torch, torch_params_to_flax

# f32 end to end on both sides; sums run in another order
ATOL = RTOL = 1e-4


def _pair(jmodule, tmodule, *args, seed=1):
    """The flax tree of ``tmodule`` randomized (every leaf), after checking
    that it has exactly the leaves and shapes of ``jmodule``'s init on
    ``args`` and that the bridge carries it back to the same state_dict;
    ``tmodule`` in eval mode, frozen."""
    init_params_(tmodule, torch.Generator().manual_seed(seed), randomize=True)
    sd = tmodule.state_dict()
    params = torch_params_to_flax(tmodule, sd)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            *map(jnp.asarray, args))["params"]
    def leaf_shapes(tree):
        return {jax.tree_util.keystr(k): v.shape
                for k, v in jax.tree_util.tree_leaves_with_path(tree)}

    want, got = leaf_shapes(shapes), leaf_shapes(params)
    assert got == want
    back = flax_params_to_torch(tmodule, params)
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    return params, tmodule.eval().requires_grad_(False)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=rtol, atol=atol)


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("name", ["leaky", "elu", "gelu", "relu", "sigmoid", "tanh", "softrelu",
                                  "softplus", "softsign", "silu", "swish", None, "identity"])
def test_every_activation_name_matches_jax(name):
    h = np.linspace(-6.0, 6.0, 241).astype(np.float32)      # 0 exactly among them
    want = np.asarray(jl.get_activation(name)(jnp.asarray(h)))
    got = tl.get_activation(name)(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_an_unknown_activation_raises_in_both():
    with pytest.raises(NotImplementedError):
        jl.get_activation("mish")
    with pytest.raises(NotImplementedError):
        tl.get_activation("mish")


# (gated, activation): the gated FFN, a kernel activation and one the kernels do not take
FFN_CASES = [(True, "leaky"), (False, "relu"), (False, "silu"), (False, "softrelu")]


@pytest.mark.parametrize("gated,act", FFN_CASES)
def test_ffn_variant_forward_and_gradients_match_jax(gated, act):
    C, hidden = 16, 64
    jffn = jl.PositionwiseFFN(units=C, hidden_size=hidden, activation_dropout=0.0, dropout=0.0,
                              gated_proj=gated, activation=act, pre_norm=True)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 5, C).astype(np.float32)
    params, tffn = _pair(jffn, tl.PositionwiseFFN(C, hidden, activation=act, gated_proj=gated), x)
    assert tffn.kernel == (not gated and act in ("relu", "silu"))
    g = rs.randn(*x.shape).astype(np.float32)
    _grads_match(tffn, params, lambda p, v: jffn.apply({"params": p}, v), lambda v: tffn(v),
                 (x,), g)


def test_t_hw_position_embedding_matches_jax():
    jpe = jl.PosEmbed(embed_dim=8, maxT=4, maxH=5, maxW=6, typ="t+hw")
    x = np.random.RandomState(0).randn(2, 3, 4, 5, 8).astype(np.float32)   # below each max
    params, tpe = _pair(jpe, tl.PosEmbed(8, 4, 5, 6, typ="t+hw"), x)
    assert tuple(tpe.HW_embed.weight.shape) == (30, 8)
    _close(tpe(torch.from_numpy(x)).numpy(), jpe.apply({"params": params}, jnp.asarray(x)))


def test_scale_shift_time_block_matches_jax():
    C, E = 32, 64
    jblk = jl.TimeEmbedResBlock(channels=C, emb_channels=E, out_channels=C,
                                use_scale_shift_norm=True, use_pallas=False)
    rs = np.random.RandomState(0)
    x, emb = rs.randn(2, 3, 4, 4, C).astype(np.float32), rs.randn(2, E).astype(np.float32)
    params, tblk = _pair(jblk, tl.TimeEmbedResBlock(C, C, emb_channels=E,
                                                    use_scale_shift_norm=True, fused=True),
                         x, emb)
    assert not tblk.fused and tuple(tblk.emb_layers[1].weight.shape) == (2 * C, E)
    _close(tblk(torch.from_numpy(x), torch.from_numpy(emb)).numpy(),
           jblk.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb)))


# the cuboid layer: (padding, shift, relative bias, final projection, global vectors, their
# self attention, separate nets, global_dim_ratio)
LAYER_CASES = {
    "no_relative_bias": ("ignore", (0, 0, 0), False, True, 0, False, False, 1),
    "no_final_proj": ("zeros", (1, 2, 2), True, False, 0, False, False, 1),
    "global_ignore_g2g_separate_ratio2": ("ignore", (1, 2, 2), True, True, 3, True, True, 2),
    "global_ignore_shared": ("ignore", (0, 0, 0), True, True, 2, False, False, 1),
    "global_zeros_g2g_shared": ("zeros", (1, 2, 2), True, True, 2, True, False, 1),
    "global_zeros_separate_ratio2_no_proj_no_bias": ("zeros", (0, 0, 0), False, False, 2, False,
                                                     True, 2),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_cuboid_layer_variant_matches_jax(case):
    pad, shift, rel, proj, N, g2g, sep, ratio = LAYER_CASES[case]
    C, heads, cs = 16, 2, (2, 4, 4)
    kw = dict(dim=C, num_heads=heads, cuboid_size=cs, shift_size=shift, strategy=("l", "l", "l"),
              padding_type=pad, use_final_proj=proj, use_relative_pos=rel,
              use_global_vector=N > 0, use_global_self_attn=g2g, separate_global_qkv=sep,
              global_dim_ratio=ratio)
    jlayer = jca.CuboidSelfAttentionLayer(**kw)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 4, 6, C).astype(np.float32)            # T and W padded to the cuboid
    args = [jnp.asarray(x)]
    if N:
        gv = rs.randn(2, N, ratio * C).astype(np.float32)
        args.append(jnp.asarray(gv))
    params, tlayer = _pair(jlayer, tca.CuboidSelfAttentionLayer(
        C, heads, cs, shift, ("l", "l", "l"), pad, use_relative_pos=rel, use_final_proj=proj,
        use_global_vector=N > 0, use_global_self_attn=g2g, separate_global_qkv=sep,
        global_dim_ratio=ratio), *args)
    assert hasattr(tlayer, "relative_position_bias_table") == rel
    assert hasattr(tlayer, "proj") == proj
    want = jax.jit(jlayer.apply)({"params": params}, *args)
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got = tlayer(targs[0], None, *targs[1:])
    if N:
        _close(got[0].numpy(), want[0])
        _close(got[1].numpy(), want[1])
    else:
        _close(got.numpy(), want)


def test_layers_route_as_the_jax_layer_decides():
    """No final projection: the grouped core where the whole-layer kernels
    would take the layer; global vectors: the einsum code, never a kernel."""
    axial = dict(dim=64, num_heads=4, cuboid_size=(4, 1, 1), strategy=("l", "l", "l"))
    shape = (1, 4, 8, 8, 64)
    assert tca.CuboidSelfAttentionLayer(**axial).route(shape) == "axial"
    no_proj = tca.CuboidSelfAttentionLayer(**axial, use_final_proj=False)
    assert no_proj.route(shape) == "grouped"
    assert no_proj.train().route(shape) == "grouped"
    no_proj.attn_drop = 0.1
    assert no_proj.route(shape) == "grouped_einsum"
    assert tca.CuboidSelfAttentionLayer(**axial, use_relative_pos=False).route(shape) == "axial"
    assert tca.CuboidSelfAttentionLayer(**axial, use_global_vector=True).route(shape) == "global"
    with pytest.raises(ValueError, match="separate_global_qkv"):
        tca.CuboidSelfAttentionLayer(**axial, use_global_vector=True, global_dim_ratio=2)


def test_cross_patterns_registry_matches_jax():
    from prediff_tpu.models.patterns import CuboidCrossAttentionPatterns as jreg
    from prediff_torch.models.patterns import CuboidCrossAttentionPatterns as treg

    names = [f"cross_{k}x{k}{s}" for k in (1, 2, 4, 8) for s in ("", "_lg", "_heter")]
    assert sorted(treg) == sorted(names)
    for name in names:
        for shape in ((4, 16, 16, 64), (2, 3, 5, 8)):
            assert treg[name](shape) == jreg.get(name)(shape), (name, shape)


# ---------------------------------------------------------------- models
# the "full" pattern (one layer a block) keeps the JAX side's compile small
UNET_VARIANT = dict(input_shape=[3, 4, 4, 8], target_shape=[2, 4, 4, 8], base_units=16,
                    num_heads=4, depth=[1, 1], attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0,
                    num_global_vectors=2, use_global_self_attn=True, separate_global_qkv=True,
                    global_dim_ratio=2, pos_embed_type="t+hw", ffn_activation="leaky",
                    use_relative_pos=False, time_embed_use_scale_shift_norm=True,
                    self_pattern="full", use_global_vector_ffn=True)
ALIGN_VARIANT = dict(input_shape=[4, 4, 4, 8], base_units=16, depth=[1, 1], out_len=2,
                     num_heads=4, attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0,
                     hierarchical_pos_embed=True, use_inter_ffn=False, readout_seq=False,
                     num_global_vectors=2, ffn_activation="silu", gated_ffn=True,
                     self_attn_use_final_proj=False, block_attn_patterns="divided_st",
                     padding_type="ignore")


def _configs(over):
    jcfg = jax_load_config(jax_default_config)
    jcfg = type(jcfg).wrap(jax_deep_merge(jcfg.to_dict(), over))
    tcfg = load_config(prediff_default_config)
    return jcfg, ConfigDict.wrap(deep_merge(tcfg.to_dict(), over))


def _torch_grads(module, fn, x, g):
    """fn(x), and the gradients of x and of every parameter (zeros where a
    leaf feeds nothing: the last block's global vectors) for the cotangent g."""
    module.requires_grad_(True)
    x = torch.from_numpy(x).requires_grad_(True)
    out = fn(x)
    grads = torch.autograd.grad(out, [x] + list(module.parameters()), torch.from_numpy(g),
                                allow_unused=True)
    module.requires_grad_(False)
    params = [torch.zeros_like(p) if gr is None else gr
              for p, gr in zip(module.parameters(), grads[1:])]
    return out.detach(), grads[0], dict(zip((n for n, _ in module.named_parameters()), params))


def _grads_close(module, got, want_tree):
    want = flax_params_to_torch(module, want_tree)
    for name, gr in got.items():
        _close(gr.numpy(), want[name].numpy())


def _grads_match(module, params, jfn, tfn, inputs, g):
    """Forward and the gradient of every parameter and of the first input,
    for the cotangent ``g``, against ``jax.vjp`` (one compiled function)."""
    @jax.jit
    def fwd_bwd(p, v, ct):
        out, vjp = jax.vjp(jfn, p, v)
        return out, vjp(ct)

    want, (want_dp, want_dx) = fwd_bwd(params, jnp.asarray(inputs[0]), jnp.asarray(g))
    out, dx, dp = _torch_grads(module, tfn, inputs[0], g)
    _close(out.numpy(), want)
    _close(dx.numpy(), want_dx)
    _grads_close(module, dp, want_dp)


def test_unet_with_global_vectors_matches_jax():
    jcfg, tcfg = _configs({"model": {"latent_model": UNET_VARIANT}})
    junet = jax_build_unet(jcfg)
    rs = np.random.RandomState(0)
    x = rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    cond = rs.randn(2, 3, 4, 4, 8).astype(np.float32)
    t = np.array([3, 777], np.int32)
    params, tunet = _pair(junet, build_unet(tcfg), x, t, cond)
    assert tuple(tunet.init_global_vectors.shape) == (2, 32)
    assert hasattr(tunet.pos_embed, "HW_embed") and len(tunet.down_layer_global_proj) == 1
    g = rs.randn(*x.shape).astype(np.float32)
    tt, tc = torch.from_numpy(t).long(), torch.from_numpy(cond)
    _grads_match(tunet, params,
                 lambda p, v: junet.apply({"params": p}, v, jnp.asarray(t), jnp.asarray(cond)),
                 lambda v: tunet(v, tt, tc), (x,), g)


def test_alignment_variant_and_its_pooled_guidance_match_jax():
    """Hierarchical position embeddings, one FFN after both attentions
    (gated, silu), no final projection, global vectors and
    ``readout_seq=False``: the forward, and the guidance shift (the gradient
    through the whole net) and energy against ``get_mean_shift`` /
    ``alignment_energy``.  The readout is (B, C); its mean over axis 1 is
    (B,), which broadcasts against the (B, 1) target to (B, B) in both
    packages."""
    jcfg, tcfg = _configs({"model": {"align": {"model_args": ALIGN_VARIANT}}})
    jnet = jax_build_alignment_model(jcfg)
    rs = np.random.RandomState(2)
    zt = (rs.randn(2, 4, 4, 4, 8) * 0.5).astype(np.float32)
    t = np.array([3, 7], np.int32)
    params, tnet = _pair(jnet, build_alignment_model(tcfg), zt, t, seed=3)
    assert len(tnet.down_self_blocks[0][0].ffn_l) == 1        # one FFN after all attentions
    assert hasattr(tnet, "down_hierarchical_pos_embed_l")
    avg = np.array([[0.4], [0.6]], np.float32)
    ja = JaxAlignment(params=params, guide_scale=50.0, apply_fn=jnet.apply)

    @jax.jit
    def reference(z):
        tj, aj = jnp.asarray(t), jnp.asarray(avg)
        return ja.predict(z, tj), ja.alignment_energy(z, tj, aj), ja.get_mean_shift(z, tj, aj)

    want, want_e, want_shift = reference(jnp.asarray(zt))
    tt = torch.from_numpy(t).long()
    out = tnet(torch.from_numpy(zt), tt)
    assert tuple(out.shape) == (2, 1)
    _close(out.numpy(), want)
    ka = KnowledgeAlignment(tnet, guide_scale=50.0)
    args = (torch.from_numpy(zt), tt, torch.from_numpy(avg))
    scale = float(np.abs(want_shift).max())
    _close(ka.get_mean_shift(*args).numpy() / scale, np.asarray(want_shift) / scale)
    energy = float(ka.alignment_energy(*args))
    assert abs(energy - float(want_e)) <= RTOL * abs(float(want_e))


def test_global_vectors_in_the_per_frame_readout_match_jax():
    """``readout_seq=True`` with global vectors: each frame's tokens, then
    the vectors (the JAX net's ``jnp.tile``); one stage."""
    over = dict(ALIGN_VARIANT, readout_seq=True, gated_ffn=False, use_inter_ffn=True,
                depth=[1], block_attn_patterns="full")
    jcfg, tcfg = _configs({"model": {"align": {"model_args": over}}})
    jnet = jax_build_alignment_model(jcfg)
    zt = np.random.RandomState(4).randn(2, 4, 4, 4, 8).astype(np.float32)
    t = np.array([5, 9], np.int32)
    params, tnet = _pair(jnet, build_alignment_model(tcfg), zt, t, seed=5)
    want = jax.jit(jnet.apply)({"params": params}, jnp.asarray(zt), jnp.asarray(t))
    got = tnet(torch.from_numpy(zt), torch.from_numpy(t).long())
    assert tuple(got.shape) == (2, 2, 1)
    _close(got.numpy(), want)


# ---------------------------------------------------------------- init modes
@pytest.mark.parametrize("kind,mode", [("linear", "0"), ("linear", "1"), ("linear", "2"),
                                       ("conv", "0"), ("conv", "1"), ("conv", "2")])
def test_init_modes_match_the_jax_initializers(kind, mode):
    """A (512, 256) Linear and a 64 -> 96 3x3 conv marked with a mode
    (``with_init``, as the factories mark them from the configuration) take
    the JAX initializer's distribution: the std within 5% and the range (a
    normal passes 3.5 std, the uniform stops at its bound); mode "2" exact
    zeros."""
    if kind == "linear":
        module, shape = nn.Linear(256, 512), (256, 512)           # flax kernel (in, out)
        want = jinit.linear_init(mode)(jax.random.PRNGKey(0), shape)
    else:
        module, shape = nn.Conv2d(64, 96, 3), (3, 3, 64, 96)
        want = jinit.conv_init(mode)(jax.random.PRNGKey(0), shape)
    init_params_(with_init(module, mode), torch.Generator().manual_seed(0))
    got, want = module.weight.detach().double(), torch.from_numpy(np.asarray(want, np.float64))
    assert not module.bias.any()
    if mode == "2":
        assert not got.any() and not want.any()
        return
    assert abs(float(got.std()) / float(want.std()) - 1.0) <= 0.05
    for t in (got, want):
        ratio = float(t.abs().max() / t.std())
        assert (ratio > 3.5) if (kind, mode) != ("conv", "0") else (ratio < 1.8), ratio


def test_factories_mark_the_configured_modes():
    """The configuration's init modes reach the layers the JAX models give
    them to, and mode "2" fills them with zeros."""
    over = dict(UNET_VARIANT, attn_linear_init_mode="2", ffn_linear_init_mode="1",
                ffn2_linear_init_mode="0", attn_proj_linear_init_mode="1", conv_init_mode="2",
                down_up_linear_init_mode="1", global_proj_linear_init_mode="0")
    _, tcfg = _configs({"model": {"latent_model": over}})
    unet = init_params_(build_unet(tcfg), torch.Generator().manual_seed(0))
    layer = unet.down_self_blocks[0][0].attn_l[0]
    marks = {"attn": [layer.qkv, layer.l2g_q_net, layer.g2g_global_qkv_net],
             "ffn": [unet.down_self_blocks[0][0].ffn_l[0].ffn_1,
                     unet.down_self_blocks[0][0].global_ffn_l[0].ffn_1],
             "ffn2": [unet.up_self_blocks[1][0].ffn_l[0].ffn_2],
             "proj": [layer.proj, layer.global_proj], "conv": [unet.upsample_layers[0].conv],
             "down": [unet.downsample_layers[0].reduction],
             "global": [unet.down_layer_global_proj[0], unet.up_layer_global_proj[0]]}
    want = {"attn": "2", "ffn": "1", "ffn2": "0", "proj": "1", "conv": "2", "down": "1",
            "global": "0"}
    for key, mods in marks.items():
        assert all(m.init_mode == want[key] for m in mods), key
        assert all(m.weight.any() != (want[key] == "2") for m in mods), key
