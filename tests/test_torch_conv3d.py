"""The bf16 3x3x3 conv route (``use_pallas_conv=True``): the port's conv op,
its gradients and its routing rule against ``prediff_tpu/ops/pallas_conv3d.py``
(interpret mode), and a UNet, an alignment net, a DDPM chain and a training
loss built with the flag against the JAX package built with it (CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import deep_merge as jax_deep_merge
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.diffusion.knowledge_alignment import KnowledgeAlignment as JaxAlignment
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.ops import pallas_conv3d
from prediff_torch.config import deep_merge, load_config, prediff_default_config
from prediff_torch.factory import (build_alignment_model, build_pipeline, build_training_pipeline,
                                   build_unet, build_vae)
from prediff_torch.models.layers import TimeEmbedResBlock
from prediff_torch.ops import conv3d
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# the JAX package's own conv test shapes (tests/test_pallas_conv3d.py)
SHAPES = [(1, 5, 8, 8, 128, 128), (2, 3, 4, 4, 128, 256)]
# f32 on both sides, only the order of the sums differs
TOL_F32 = 1e-5
# bf16 operands rounded at the same points on both sides, f32 sums in another
# order: a few e-6 of the output's scale
TOL_BF16 = 2e-5


def _data(B, T, H, W, C, OC, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.rand(B, T, H, W, C) - 0.5).astype(np.float32)
    k = (rs.rand(3, 3, 3, C, OC) * 0.05).astype(np.float32)
    b = rs.rand(OC).astype(np.float32)
    return x, k, b


def _torch_weight(k):
    """(3, 3, 3, C, OC) -> Conv3d (OC, C, 3, 3, 3), the weight bridge's layout."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(4, 3, 0, 1, 2)))


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_conv_plain_matches_jax(shape, mxu):
    """f32: against ``conv3x3x3_reference``; bf16: against the interpret-mode
    kernel, which rounds x and the kernel to bf16 and accumulates in f32."""
    x, k, b = _data(*shape)
    if mxu == "float32":
        want = pallas_conv3d.conv3x3x3_reference(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
        got = conv3d.conv3x3x3_plain(torch.from_numpy(x), _torch_weight(k), torch.from_numpy(b),
                                     mxu_dtype=None)
        _close(got, want, TOL_F32)
    else:
        want = pallas_conv3d.fused_conv3x3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                             "bfloat16", interpret=True)
        got = conv3d.fused_conv3x3x3(torch.from_numpy(x), _torch_weight(k), torch.from_numpy(b))
        _close(got, want, TOL_BF16)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_gradients_match_jax(shape):
    """dx (the kernel on the flipped weights where the gate admits the
    cotangent, bf16), dw (f32, from the unrounded x) and db against
    ``jax.grad`` of ``fused_conv3x3x3_diff(x, k, b, "bfloat16", True)``."""
    B, T, H, W, C, OC = shape
    x, k, b = _data(*shape, seed=1)
    g = (np.random.RandomState(2).rand(B, T, H, W, OC) - 0.5).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(pallas_conv3d.fused_conv3x3x3_diff(*a, "bfloat16", True)
                                       * jnp.asarray(g)), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    leaves = [torch.from_numpy(x).requires_grad_(True), _torch_weight(k).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    out = conv3d.fused_conv3x3x3(*leaves)
    dx, dw, db = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert pallas_conv3d.supports_shape(T, H, W, OC, C, B)   # dx takes the kernel route
    _close(dx, want[0], TOL_BF16)
    _close(dw.permute(2, 3, 4, 1, 0), want[1], TOL_F32)
    _close(db, want[2], TOL_F32)


def test_conv_dx_outside_the_gate_is_f32():
    """A forward the gate admits whose cotangent it refuses (wider on the way
    back) takes the f32 transposed conv for dx, as the JAX backward takes its
    f32 reference there."""
    B, T, H, W, C, OC = 2, 1, 22, 22, 128, 512
    for s in (conv3d.supports_shape, pallas_conv3d.supports_shape):
        assert s(T, H, W, C, OC, B) and not s(T, H, W, OC, C, B)
    rs = np.random.RandomState(3)
    g = torch.from_numpy(rs.randn(B, T, H, W, OC).astype(np.float32))
    w = torch.from_numpy((rs.randn(OC, C, 3, 3, 3) * 0.05).astype(np.float32))
    x = torch.zeros(B, T, H, W, C, requires_grad=True)
    dx, = torch.autograd.grad(conv3d.fused_conv3x3x3(x, w, torch.zeros(OC)), x, g)
    assert torch.equal(dx, conv3d.conv3x3x3_dx_plain(g, w, mxu_dtype=None))


# every site of the issue's table (UNet first_proj, stage 0, stage 1; the
# alignment net's first_proj), the JAX test's refusals, and a few more
GATE_SHAPES = [(13, 16, 16, 65, 256), (13, 16, 16, 256, 256), (13, 8, 8, 512, 512),
               (6, 16, 16, 64, 128), (6, 16, 16, 128, 128), (6, 8, 8, 256, 256),
               (13, 16, 16, 256, 192), (13, 64, 64, 1024, 1024), (5, 8, 8, 128, 128),
               (3, 4, 4, 128, 256), (5, 4, 4, 128, 128), (5, 2, 2, 256, 256)]


@pytest.mark.parametrize("shape", GATE_SHAPES)
def test_gate_matches_jax(shape):
    for B in (1, 2, 8):
        assert conv3d.supports_shape(*shape, B) == pallas_conv3d.supports_shape(*shape, B=B), B


def test_gate_on_the_v1_sites():
    """The routes the v1 recipe takes: B=1 sends UNet stage 0 and stage 1 (and
    first_proj's second conv) to the bf16 conv, B=2 stage 1 only; the
    alignment net's first_proj second conv at both."""
    s = conv3d.supports_shape
    assert [s(13, 16, 16, 256, 256, B) for B in (1, 2)] == [True, False]
    assert [s(13, 8, 8, 512, 512, B) for B in (1, 2)] == [True, True]
    assert [s(6, 16, 16, 128, 128, B) for B in (1, 2)] == [True, True]
    assert not s(13, 16, 16, 65, 256, 1) and not s(6, 16, 16, 64, 128, 1)


def _with(cfg, over):
    return type(cfg).wrap(deep_merge(cfg.to_dict(), over))


@pytest.mark.parametrize("value,route", [(True, True), (False, False), ("auto", False)])
def test_factories_read_use_pallas_conv(value, route):
    """True routes the eligible convs to the bf16 kernel; False and "auto" keep
    the f32 convs, which the JAX package computes off a TPU for both."""
    cfg = load_config(prediff_default_config, TINY)
    cfg = _with(cfg, {"model": {"latent_model": {"use_pallas_conv": value},
                                "align": {"model_args": {"use_pallas_conv": value}}}})
    unet, align = build_unet(cfg), build_alignment_model(cfg)
    blocks = [unet.first_proj, *unet.down_time_embed_blocks, *unet.up_time_embed_blocks,
              align.first_proj]
    assert all(b.conv_kernel is route for b in blocks)
    assert all(not b.conv_kernel for b in align.down_time_embed_blocks)  # the resblock kernel


@pytest.mark.parametrize("section", ["latent_model", "align"])
@pytest.mark.parametrize("value", ["yes", 1, None])
def test_factories_refuse_other_values(section, value):
    cfg = load_config(prediff_default_config, TINY)
    over = ({"latent_model": {"use_pallas_conv": value}} if section == "latent_model"
            else {"align": {"model_args": {"use_pallas_conv": value}}})
    cfg = _with(cfg, {"model": over})
    with pytest.raises(ValueError, match="use_pallas_conv"):
        (build_unet if section == "latent_model" else build_alignment_model)(cfg)


def test_resblock_routes_per_call():
    """One block routes by the call's shape and batch: stage 0 of the v1 UNet
    takes the kernel at B=1 and the f32 conv at B=2."""
    block = TimeEmbedResBlock(256, 256, emb_channels=8, conv_kernel=True).eval()
    calls = []
    # every routed forward reaches conv3x3x3_forward (under no_grad without the
    # autograd.Function)
    orig = conv3d.conv3x3x3_forward
    conv3d.conv3x3x3_forward = lambda *a: calls.append(a[0].shape) or orig(*a)
    try:
        with torch.no_grad():
            for B in (1, 2):
                block(torch.zeros(B, 13, 16, 16, 256), torch.zeros(B, 8))
    finally:
        conv3d.conv3x3x3_forward = orig
    assert calls == [torch.Size([1, 13, 16, 16, 256])] * 2


# --------------------------------------------------------------------------- #
# A tiny UNet and alignment net at widths the gate admits (base_units 128).

WIDE = {"latent_model": {"base_units": 128, "use_pallas_conv": True},
        "align": {"model_args": {"base_units": 128, "use_pallas_conv": True}}}
# UNet forward, chain, loss and gradients: bf16 conv operands on both sides at
# the same points, but an f32 sum-order difference upstream (GN, attention,
# FFN) flips a bf16 rounding here and there, and the randomized depth
# amplifies it (rel-L2 ~3e-4 to 8e-4 on these seeds).  So each is held to a
# bf16-level bar and, what shows the route, to at most half the error of the
# same port with its f32 convs against the same JAX model (3x that, or more)
TOL_NET, TOL_LOSS, ROUTE_MARGIN = 2e-3, 2e-4, 0.5
TOL_BLOCK = 1e-4
# the alignment net: built with the same flags, the JAX package runs its
# stage blocks' convs through the bf16 conv off a TPU (its resblock kernel is
# "auto", off there), the port runs them in its resblock, whose plain version
# on the CPU is f32; so bf16-level agreement (its one conv-route site,
# first_proj, is held tightly on its own below)
TOL_ALIGN_REL_L2 = 2e-2


def _random_params(model, seed, *inputs):
    """Every leaf of ``model``'s tree random (``randomize_flax``), from the
    shapes alone: the tree is traced, not initialised."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)["params"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return randomize_flax(zeros, seed)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def wide():
    from prediff_tpu.factory import build_alignment_model as jax_build_alignment_model
    from prediff_tpu.factory import build_unet as jax_build_unet
    from prediff_tpu.factory import build_vae as jax_build_vae

    jcfg = jax_load_config(jax_default_config, TINY)
    jcfg = type(jcfg).wrap(jax_deep_merge(jcfg.to_dict(), {"model": WIDE}))
    d, a = jcfg.model.diffusion, jcfg.model.align.model_args
    jparams = {
        "unet": _random_params(jax_build_unet(jcfg), 21, jnp.zeros((1, *d.latent_shape)),
                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, *d.latent_cond_shape))),
        "vae": _random_params(jax_build_vae(jcfg), 22, jnp.zeros((1, 32, 32, 1))),
        "align": _random_params(jax_build_alignment_model(jcfg), 23,
                                jnp.zeros((1, *a.input_shape)), jnp.zeros((1,), jnp.int32))}
    jld, _ = jax_build_pipeline(jcfg, unet_params=jparams["unet"], vae_params=jparams["vae"],
                                align_params=jparams["align"], with_alignment=True)
    tcfg = _with(load_config(prediff_default_config, TINY), {"model": WIDE})
    state = {"unet": flax_params_to_torch(build_unet(tcfg), jparams["unet"]),
             "vae": flax_params_to_torch(build_vae(tcfg), jparams["vae"]),
             "align": flax_params_to_torch(build_alignment_model(tcfg), jparams["align"])}
    ld = build_pipeline(tcfg, with_alignment=True, device="cpu", params=state)
    return jld, jparams, ld, tcfg, state


def test_wide_unet_routes_every_eligible_conv(wide):
    _, _, ld, _, _ = wide
    calls = []
    orig = conv3d.conv3x3x3_forward
    conv3d.conv3x3x3_forward = lambda *a: calls.append(tuple(a[0].shape)) or orig(*a)
    rs = np.random.RandomState(4)
    try:
        with torch.no_grad():
            ld.unet(torch.from_numpy(rs.randn(1, 2, 4, 4, 8).astype(np.float32)),
                    torch.tensor([3]), torch.from_numpy(rs.randn(1, 3, 4, 4, 8).astype(np.float32)))
    finally:
        conv3d.conv3x3x3_forward = orig
    # first_proj's second conv, and both convs of each of 2 x 2 time-block calls per stage
    assert len(calls) == 1 + 2 * 2 * sum(ld.unet.depth)


class _f32_convs:
    """Within: ``model``'s conv-route blocks take their f32 convs."""

    def __init__(self, model):
        self.blocks = [m for m in model.modules() if getattr(m, "conv_kernel", False)]

    def __enter__(self):
        for m in self.blocks:
            m.conv_kernel = False

    def __exit__(self, *exc):
        for m in self.blocks:
            m.conv_kernel = True


def _holds_route(err_route, err_f32, tol):
    assert err_route <= tol and err_route <= ROUTE_MARGIN * err_f32, (err_route, err_f32)


@pytest.fixture(scope="module")
def unet_b2(wide):
    """A B=2 UNet forward, loss and every gradient of the JAX model, in one
    compile, with its draws."""
    jld, jparams, _, _, _ = wide
    rs = np.random.RandomState(8)
    d = dict(z=rs.randn(2, 2, 4, 4, 8).astype(np.float32),
             zc=rs.randn(2, 3, 4, 4, 8).astype(np.float32), t=np.array([1, 6], np.int32),
             noise=rs.randn(2, 2, 4, 4, 8).astype(np.float32),
             logvar=(0.3 * rs.randn(jld.num_timesteps)).astype(np.float32))

    @jax.jit
    def run(p, z, zc, t, noise):
        out = jld.unet_apply({"params": p["unet"]}, z, t, zc)
        loss, grads = jax.value_and_grad(
            lambda q: jld.p_losses(q["unet"], q["logvar"], z, zc, t, noise, train=False)[0])(p)
        return out, loss, grads

    want = run({"unet": jparams["unet"], "logvar": jnp.asarray(d["logvar"])},
               *(jnp.asarray(d[k]) for k in ("z", "zc", "t", "noise")))
    return d, jax.tree_util.tree_map(np.asarray, want)


def test_wide_unet_forward_matches_jax(wide, unet_b2):
    _, _, ld, _, _ = wide
    d, (want, _, _) = unet_b2
    args = (torch.from_numpy(d["z"]), torch.from_numpy(d["t"]).long(), torch.from_numpy(d["zc"]))
    with torch.no_grad():
        got = ld.unet(*args)
        with _f32_convs(ld.unet):
            f32 = ld.unet(*args)
    _holds_route(_rel_l2(got, want), _rel_l2(f32, want), TOL_NET)


def test_wide_training_loss_and_gradients_match_jax(wide, unet_b2):
    """A B=2 loss and the gradient of every UNet leaf: dx of the conv route
    from the kernel on the flipped weights, dw and db in f32."""
    _, _, _, tcfg, state = wide
    d, (_, want_loss, jgrads) = unet_b2
    ld = build_training_pipeline(tcfg, device="cpu", params=state)
    want = flax_train_tree_to_torch(ld.unet, jgrads)
    names = [f"unet.{k}" for k, _ in ld.unet.named_parameters()] + ["logvar"]
    assert sorted(names) == sorted(want)
    assert all(float(want[n].abs().max()) > 0 for n in names)   # no leaf trivially 0
    want_all = torch.cat([want[n].flatten() for n in names])

    def loss_and_grads():
        lv = torch.from_numpy(d["logvar"]).requires_grad_(True)
        loss, _ = ld.p_losses(lv, torch.from_numpy(d["z"]), torch.from_numpy(d["zc"]),
                              torch.from_numpy(d["t"]).long(), torch.from_numpy(d["noise"]))
        grads = torch.autograd.grad(loss, list(ld.unet.parameters()) + [lv])
        return (abs(float(loss.detach()) - float(want_loss)) / abs(float(want_loss)),
                _rel_l2(torch.cat([g.flatten() for g in grads]), want_all))

    loss_err, grad_err = loss_and_grads()
    with _f32_convs(ld.unet):
        loss_f32, grad_f32 = loss_and_grads()
    _holds_route(loss_err, loss_f32, TOL_LOSS)
    _holds_route(grad_err, grad_f32, TOL_NET)


def test_wide_guidance_shift_matches_jax(wide):
    jld, jparams, ld, _, _ = wide
    rs = np.random.RandomState(6)
    zt = rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    t = np.array([2, 5], np.int32)
    avg = np.array([[0.4], [0.6]], np.float32)
    ka_jax = JaxAlignment(params=jparams["align"], guide_scale=50.0,
                          apply_fn=jld.alignment.apply_fn)
    want = np.asarray(jax.jit(ka_jax.get_mean_shift)(jnp.asarray(zt), jnp.asarray(t),
                                                     jnp.asarray(avg)))
    ka = type(ld.alignment)(ld.alignment.model, guide_scale=50.0)
    got = ka.get_mean_shift(torch.from_numpy(zt), torch.from_numpy(t).long(),
                            torch.from_numpy(avg)).numpy()
    cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert _rel_l2(got, want) <= TOL_ALIGN_REL_L2 and cos >= 0.999


def test_wide_ddpm_chain_matches_jax(wide):
    """Four temperature-0 DDPM steps through both pipelines: VAE encode, the
    UNet on the conv route, VAE decode."""
    jld, jparams, ld, _, _ = wide
    rs = np.random.RandomState(7)
    y = rs.rand(1, 3, 32, 32, 1).astype(np.float32)
    x_T = rs.randn(1, 2, 4, 4, 8).astype(np.float32)
    want = jld.sample(jparams["unet"], jparams["vae"], jax.random.PRNGKey(0), jnp.asarray(y),
                      x_T=jnp.asarray(x_T), temperature=0.0, timesteps=4)
    got = ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), temperature=0.0, timesteps=4)
    with _f32_convs(ld.unet):
        f32 = ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), temperature=0.0,
                        timesteps=4)
    assert got.shape == (1, 2, 32, 32, 1)
    _holds_route(_rel_l2(got, want), _rel_l2(f32, want), TOL_NET)


def test_alignment_first_proj_matches_flax():
    """The alignment net's one conv-route site, its first_proj block (64 ->
    128 channels, 1x1 skip; only the second conv is admitted), forward and
    input gradient (what guidance takes) against the flax block built with
    use_pallas_conv=True (interpret mode)."""
    from prediff_tpu.models.layers import TimeEmbedResBlock as JaxBlock

    rs = np.random.RandomState(9)
    x = rs.randn(1, 6, 16, 16, 64).astype(np.float32)
    g = rs.randn(1, 6, 16, 16, 128).astype(np.float32)
    jblock = JaxBlock(channels=64, out_channels=128, use_embed=False, use_pallas_conv=True)
    params = _random_params(jblock, 10, jnp.asarray(x))

    @jax.jit
    def fwd_vjp(v, ct):
        out, vjp = jax.vjp(lambda u: jblock.apply({"params": params}, u), v)
        return out, vjp(ct)[0]

    want, want_dx = fwd_vjp(jnp.asarray(x), jnp.asarray(g))
    block = TimeEmbedResBlock(64, 128, use_embed=False, conv_kernel=True).eval()
    block.load_state_dict(flax_params_to_torch(block, params))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = block(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert conv3d.supports_shape(6, 16, 16, 128, 128, 1)
    # one block, the same bf16 roundings; a GroupNorm sum-order difference may
    # flip a rounding here and there (rel-L2 ~1e-6; the f32 convs: ~2e-3)
    assert _rel_l2(out.detach(), want) <= TOL_BLOCK
    assert _rel_l2(dx, want_dx) <= TOL_BLOCK
