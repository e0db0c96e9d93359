"""The configuration's ``use_pallas_attention`` / ``use_pallas_ffn`` /
``use_pallas_gn`` / ``use_pallas_resblock``: with False the JAX layers
compute their flax path on every backend, and so do the port's, on their
library routes, at widths the kernels take (128 for the FFN, else 64).  On the CPU, per key: the
port's layer built with False against the JAX layer built with False on the
same numpy inputs and randomized weights, forward and input gradient
(f32 on both sides), with the kernel's wrapper made to raise (the route
takes no kernel); the factories' reading of every value (True and "auto"
keep the kernels, ``use_pallas_attention: true`` the grouped kernel for
every layer, False and "grouped" the einsum code), and an unknown value
raising ``ValueError``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_routing import _grad_pair
from test_torch_unet import randomize_flax

import prediff_torch.models.cuboid_attention as tattention
import prediff_torch.models.layers as tlayers
from prediff_tpu.models.cuboid_attention import CuboidSelfAttentionLayer as JaxLayer
from prediff_tpu.models.layers import PositionwiseFFN as JaxFFN
from prediff_tpu.models.layers import TimeEmbedResBlock as JaxBlock
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_alignment_model, build_unet
from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
from prediff_torch.models.layers import PositionwiseFFN, TimeEmbedResBlock
from prediff_torch.ops import ffn, groupnorm, resblock
from prediff_torch.utils.convert import flax_params_to_torch

C = 64   # a width the attention, GroupNorm and resblock kernels take
TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")


def _refuse(monkeypatch, module, name):
    def raising(*args, **kwargs):
        raise AssertionError(f"{name} ran: the switch was ignored")

    monkeypatch.setattr(module, name, raising)


def test_use_pallas_ffn_false_matches_flax_false(monkeypatch):
    c = 128   # the FFN kernels' narrowest width
    x = np.random.RandomState(1).randn(2, 3, 4, 4, c).astype(np.float32)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jmod = JaxFFN(units=c, hidden_size=4 * c, activation="gelu", pre_norm=True,
                  activation_dropout=0.0, dropout=0.0, use_pallas=False)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 3)
    tmod = PositionwiseFFN(c, 4 * c, kernel=False).eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert ffn.supports_shape(x.size // c, c, 4 * c)
    _refuse(monkeypatch, tlayers, "fused_ffn")
    _grad_pair(jmod, params, x, g, tmod)


@pytest.mark.parametrize("cs,strategy,route", [((3, 1, 1), ("l", "l", "l"), "axial"),
                                               ((1, 2, 2), ("d", "d", "d"), "v4")])
def test_use_pallas_attention_false_matches_flax_false(monkeypatch, cs, strategy, route):
    x = np.random.RandomState(3).randn(2, 3, 4, 4, C).astype(np.float32)
    g = np.random.RandomState(4).randn(*x.shape).astype(np.float32)
    jmod = JaxLayer(dim=C, num_heads=4, cuboid_size=cs, strategy=strategy, padding_type="zeros",
                    use_pallas_attention=False)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    tmod = CuboidSelfAttentionLayer(C, 4, cs, strategy=strategy, padding_type="zeros",
                                    kernels="einsum").eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert tmod.route(x.shape) == "einsum"
    kept = CuboidSelfAttentionLayer(C, 4, cs, strategy=strategy, padding_type="zeros")
    assert kept.route(x.shape) == route                       # "auto": the kernel route
    grouped = CuboidSelfAttentionLayer(C, 4, cs, strategy=strategy, padding_type="zeros",
                                       kernels="grouped")
    assert grouped.route(x.shape) == "grouped"                # True: the grouped kernel
    for name in ("fused_axial_attention", "fused_cuboid_attention_layer",
                 "fused_cuboid_attention_grouped"):
        _refuse(monkeypatch, tattention, name)
    _grad_pair(jmod, params, x, g, tmod)


def test_use_pallas_gn_false_matches_flax_false(monkeypatch):
    rs = np.random.RandomState(5)
    x = rs.randn(2, 2, 4, 4, C).astype(np.float32)
    emb = rs.randn(2, 4 * C).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    jmod = JaxBlock(channels=C, emb_channels=4 * C, use_pallas=False)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
                            ["params"], 6)
    tmod = TimeEmbedResBlock(C, C, emb_channels=4 * C, gn_kernel=False).eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert groupnorm.supports(C, tmod.in_groups)
    _refuse(monkeypatch, tlayers, "fused_groupnorm_silu")
    _grad_pair(_Bound(jmod, emb), params, x, g, _TorchBound(tmod, emb))


def test_use_pallas_resblock_false_matches_flax_false(monkeypatch):
    rs = np.random.RandomState(7)
    x = rs.randn(1, 2, 4, 4, C).astype(np.float32)
    emb = rs.randn(1, 4 * C).astype(np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    jmod = JaxBlock(channels=C, emb_channels=4 * C, use_pallas_resblock=False)
    params = randomize_flax(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
                            ["params"], 8)
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.align.model_args["use_pallas_resblock"] = False
    assert not build_alignment_model(cfg).down_time_embed_blocks[0].fused
    tmod = TimeEmbedResBlock(C, C, emb_channels=4 * C, fused=False).eval()
    tmod.load_state_dict(flax_params_to_torch(tmod, params))
    assert resblock.supports(C, tmod.in_groups)
    _refuse(monkeypatch, tlayers, "fused_resblock")
    _grad_pair(_Bound(jmod, emb), params, x, g, _TorchBound(tmod, emb))


class _Bound:
    """The flax block's call with its embedding bound."""

    def __init__(self, jmod, emb):
        self.jmod, self.emb = jmod, jnp.asarray(emb)

    def apply(self, variables, a):
        return self.jmod.apply(variables, a, self.emb)


class _TorchBound(torch.nn.Module):
    def __init__(self, tmod, emb):
        super().__init__()
        self.tmod, self.emb = tmod, torch.from_numpy(emb)

    def forward(self, a):
        return self.tmod(a, self.emb)


def _switches(model):
    """What a built model runs: the attention layers' ``kernels``, the
    FFNs' ``kernel``, the GN sites' ``gn_kernel`` and the fused resblocks."""
    mods = list(model.modules())
    return ({m.kernels for m in mods if isinstance(m, CuboidSelfAttentionLayer)},
            {m.kernel for m in mods if isinstance(m, PositionwiseFFN)},
            {m.gn_kernel for m in mods if isinstance(m, TimeEmbedResBlock)},
            {m.fused for m in mods if isinstance(m, TimeEmbedResBlock) and m.use_embed})


@pytest.mark.parametrize("value,attention_kernels,kernel", [
    ("auto", "layer", True), (True, "grouped", True), (False, "einsum", False),
    ("layer", "layer", None), ("grouped", "einsum", None)])
def test_the_factories_read_every_switch(value, attention_kernels, kernel):
    for build, section in ((build_unet, "latent_model"), (build_alignment_model, "align")):
        cfg = load_config(prediff_default_config, TINY)
        sec = cfg.model[section] if section == "latent_model" else cfg.model.align.model_args
        sec["use_pallas_attention"] = value
        if kernel is not None:
            for key in ("use_pallas_ffn", "use_pallas_gn", "use_pallas_resblock"):
                sec[key] = value
        kernels, ffns, gns, fused = _switches(build(cfg))
        assert kernels == {attention_kernels}
        want = True if kernel is None else kernel
        assert ffns == gns == {want}
        if build is build_alignment_model:
            assert fused == {want}
        else:
            assert fused == {False}          # the UNet's time blocks run unfused either way


@pytest.mark.parametrize("key", ["use_pallas_attention", "use_pallas_ffn", "use_pallas_gn",
                                 "use_pallas_resblock"])
def test_an_unknown_switch_value_raises(key):
    for build, section in ((build_unet, "latent_model"), (build_alignment_model, "align")):
        cfg = load_config(prediff_default_config, TINY)
        sec = cfg.model[section] if section == "latent_model" else cfg.model.align.model_args
        sec[key] = "sometimes"
        with pytest.raises(ValueError, match=key):
            build(cfg)
