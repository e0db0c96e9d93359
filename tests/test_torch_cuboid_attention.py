"""The general cuboid layer and the grouped masked core: the port's plain
versions against the JAX references and the interpret-mode Pallas kernels
(v4 layer, its input gradient, the grouped core), the ``autograd.Function``s
against autograd of the plain versions, the port's ``CuboidSelfAttentionLayer``
against the flax layer on every route, and the ``configs/tiny_smoke.yaml``
UNet forward and a guided chain with a shifted, padded pattern against the
JAX package (CPU).  The CUDA kernels are held against the plain versions in
test_torch_kernels_cuda.py."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention import TOL_F32, _torch_args, assert_bf16_close
from test_torch_unet import randomize_flax

from prediff_tpu.config import deep_merge
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.models.cuboid_attention import CuboidSelfAttentionLayer as JaxLayer
from prediff_tpu.ops import cuboid as jax_cuboid
from prediff_tpu.ops import pallas_attention
from prediff_torch.config import ConfigDict, load_config, prediff_default_config
from prediff_torch.factory import build_alignment_model, build_unet, build_vae
from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
from prediff_torch.ops.attention import (cuboid_attention_bwd_dx_plain, cuboid_attention_plain,
                                         fused_cuboid_attention_grouped,
                                         fused_cuboid_attention_layer,
                                         fused_cuboid_attention_layer_bwd_dx,
                                         grouped_attention_plain)
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 end to end on both sides, another sum order: the layer, the UNet, the chain
ATOL = RTOL = 1e-4


def _layer_inputs(shape, heads, seed):
    """x (B, cuboids, vol, C) and the layer's weights, flax layout."""
    rs = np.random.RandomState(seed)
    B, nC, vol, C = shape
    return (rs.randn(*shape).astype(np.float32), (1.0 + 0.1 * rs.randn(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),
            (0.5 * rs.randn(heads, vol, vol)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32))


def test_v4_plain_matches_jax_reference():
    heads = 4
    args = _layer_inputs((2, 6, 24, 32), heads, 0)
    scale = 8 ** -0.5
    want = np.asarray(pallas_attention.cuboid_layer_attention_reference(
        *map(jnp.asarray, args), heads, scale))
    got = cuboid_attention_plain(*_torch_args(*args), heads, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)


# (B, cuboids, vol, C): G = 4 (the UNet's 13x16x16 layer at vol 64 packs 4),
# G = 1 at vol 144 (two cuboids do not fit 256 rows)
@pytest.mark.parametrize("shape", [(1, 8, 64, 128), (1, 2, 144, 128)])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_v4_plain_matches_interpret_kernel(shape, mxu):
    heads = 4
    args = _layer_inputs(shape, heads, 1)
    scale = 32 ** -0.5
    G = pallas_attention.pick_cuboid_group(shape[1], shape[2], C=shape[3], num_heads=heads)
    assert G == (4 if shape[2] == 64 else 1)
    want = np.asarray(pallas_attention.fused_cuboid_attention_layer_v4(
        *map(jnp.asarray, args), num_heads=heads, scale=scale, mxu_dtype_name=mxu,
        interpret=True))
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = cuboid_attention_plain(*_torch_args(*args), heads, scale, mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def test_v4_plain_matches_interpret_kernel_on_dilated_cuboids():
    """Each side reorders the natural layout into dilated 1x4x4 cuboids
    (G = 16 of vol 16 per TPU grid cell), then runs the layer and reverses."""
    from prediff_torch.ops.cuboid import cuboid_reorder, cuboid_reorder_reverse
    heads, cs, st = 4, (1, 4, 4), ("d", "d", "d")
    x = np.random.RandomState(14).randn(1, 4, 8, 8, 128).astype(np.float32)
    args = _layer_inputs((1, 16, 16, 128), heads, 15)[1:]
    scale = 32 ** -0.5
    xr = jax_cuboid.cuboid_reorder(jnp.asarray(x), cs, st)
    want = np.asarray(jax_cuboid.cuboid_reorder_reverse(
        pallas_attention.fused_cuboid_attention_layer_v4(
            xr, *map(jnp.asarray, args), num_heads=heads, scale=scale, interpret=True),
        cs, st, (4, 8, 8)))
    t = _torch_args(x, *args)
    got = cuboid_attention_plain(cuboid_reorder(t[0], cs, st), *t[1:], heads, scale,
                                 mxu_dtype=torch.bfloat16)
    assert_bf16_close(cuboid_reorder_reverse(got, cs, st, (4, 8, 8)).numpy(), want)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_v4_plain_dx_matches_interpret_kernel(mxu):
    heads, shape = 4, (1, 8, 64, 128)
    args = _layer_inputs(shape, heads, 2)
    g = np.random.RandomState(3).randn(*shape).astype(np.float32)
    scale = 32 ** -0.5
    want = np.asarray(pallas_attention.fused_cuboid_attention_layer_v4_bwd_dx(
        jnp.asarray(args[0]), jnp.asarray(g), *map(jnp.asarray, args[1:6]), num_heads=heads,
        scale=scale, mxu_dtype_name=mxu, interpret=True))
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    t = _torch_args(*args)
    got = cuboid_attention_bwd_dx_plain(t[0], torch.from_numpy(g), *t[1:6], heads, scale,
                                        mxu_dtype=dtype).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, rtol=TOL_F32, atol=TOL_F32)
    else:
        assert_bf16_close(got, want)


def test_v4_function_gives_plain_autograd_grads_on_cpu():
    heads, shape = 2, (2, 3, 12, 16)
    t = _torch_args(*_layer_inputs(shape, heads, 4))
    g = torch.from_numpy(np.random.RandomState(5).randn(*shape).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in t]
    want = torch.autograd.grad(cuboid_attention_plain(leaves[0], *leaves[1:], heads, 0.3),
                               leaves, g)
    torch.testing.assert_close(cuboid_attention_bwd_dx_plain(t[0], g, *t[1:6], heads, 0.3),
                               want[0], rtol=TOL_F32, atol=TOL_F32)
    before = (fused_cuboid_attention_layer.launches, fused_cuboid_attention_layer_bwd_dx.launches)
    leaves = [a.clone().requires_grad_(True) for a in t]
    got = torch.autograd.grad(fused_cuboid_attention_layer(leaves[0], *leaves[1:], heads, 0.3),
                              leaves, g)
    for name, w, gt in zip(("x", "ln_w", "ln_b", "w_qkv", "bias", "w_proj", "b_proj"), want, got):
        torch.testing.assert_close(gt, w, rtol=TOL_F32, atol=TOL_F32, msg=name)
    # guidance: dx alone
    x = t[0].clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(fused_cuboid_attention_layer(x, *t[1:], heads, 0.3), [x], g)
    torch.testing.assert_close(dx, want[0], rtol=TOL_F32, atol=TOL_F32)
    assert (fused_cuboid_attention_layer.launches,
            fused_cuboid_attention_layer_bwd_dx.launches) == before


def _grouped_inputs(B, heads, nC, vol, hc, seed, masked, empty_row=False):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(B, heads, nC, vol, hc).astype(np.float32) for _ in range(3))
    bias = (0.5 * rs.randn(heads, vol, vol)).astype(np.float32)
    mask = None
    if masked:
        mask = rs.rand(nC, vol, vol) > 0.3
        if empty_row:
            mask[0, 3] = False
    return q, k, v, bias, mask


GROUPED_CASES = [dict(masked=False), dict(masked=True), dict(masked=True, empty_row=True)]


@pytest.mark.parametrize("case", GROUPED_CASES, ids=["nomask", "mask", "empty_row"])
def test_grouped_plain_matches_jax_reference_and_interpret_kernel(case):
    q, k, v, bias, mask = _grouped_inputs(2, 2, 4, 20, 8, 6, **case)
    jm = None if mask is None else jnp.asarray(mask)
    scale = 0.35
    ref = np.asarray(pallas_attention.grouped_attention_reference(
        *map(jnp.asarray, (q, k, v, bias)), mask=jm, scale=scale))
    kern = np.asarray(pallas_attention.fused_cuboid_attention_grouped(
        *map(jnp.asarray, (q, k, v, bias)), mask=jm, scale=scale, interpret=True))
    t = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = grouped_attention_plain(*t, None if mask is None else torch.from_numpy(mask),
                                  scale).numpy()
    np.testing.assert_allclose(got, ref, rtol=TOL_F32, atol=TOL_F32)
    np.testing.assert_allclose(got, kern, rtol=TOL_F32, atol=TOL_F32)
    if case.get("empty_row"):
        assert (got[:, :, 0, 3] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
def test_grouped_function_backward_matches_jax_vjp(masked):
    q, k, v, bias, mask = _grouped_inputs(1, 2, 3, 16, 8, 7, masked, empty_row=masked)
    g = np.random.RandomState(8).randn(*q.shape).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: pallas_attention.grouped_attention_reference(
        *a, mask=jm, scale=0.4), *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    before = fused_cuboid_attention_grouped.launches
    out = fused_cuboid_attention_grouped(*leaves, None if mask is None else torch.from_numpy(mask),
                                         0.4)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, w, gt in zip("qkvb", want, got):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
    assert fused_cuboid_attention_grouped.launches == before


# (T, H, W), cuboid, shift, strategy, padding type, route: one layer of each
# kind the patterns give
LAYER_CASES = [
    ((5, 6, 6), (1, 6, 6), (0, 0, 0), ("l", "l", "l"), "zeros", "v4"),          # divided_st
    ((5, 6, 6), (1, 2, 2), (0, 0, 0), ("d", "d", "d"), "zeros", "v4"),          # spatial_lg
    ((5, 6, 6), (1, 3, 1), (0, 0, 0), ("d", "d", "d"), "zeros", "v4"),          # space dilate
    ((5, 6, 6), (2, 4, 4), (0, 0, 0), ("l", "l", "l"), "zeros", "grouped"),     # padded
    ((5, 6, 6), (2, 4, 4), (0, 0, 0), ("l", "l", "l"), "ignore", "grouped_masked"),
    ((5, 6, 6), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "zeros", "grouped_masked"),  # shifted
    ((5, 6, 6), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "nearest", "grouped_masked"),
    ((4, 6, 6), (1, 3, 3), (0, 1, 1), ("l", "l", "l"), "ignore", "grouped_masked"),
    ((5, 8, 8), (5, 8, 8), (0, 0, 0), ("l", "l", "l"), "zeros", "grouped"),     # full, vol 320
    ((5, 6, 6), (5, 1, 1), (0, 0, 0), ("l", "l", "l"), "zeros", "axial"),
]


def _layer_pair(T, H, W, cs, shift, strategy, padding_type, seed, C=64, heads=4):
    # C = 64: a width the axial and v4 kernels take (at 32 both route to einsum)
    jl = JaxLayer(dim=C, num_heads=heads, cuboid_size=cs, shift_size=shift, strategy=strategy,
                  padding_type=padding_type)
    x = np.random.RandomState(seed).randn(2, T, H, W, C).astype(np.float32)
    params = randomize_flax(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed)
    tl = CuboidSelfAttentionLayer(C, heads, cs, shift, strategy, padding_type).eval()
    tl.load_state_dict(flax_params_to_torch(tl, params))
    return jl, params, tl, x


@pytest.mark.parametrize("shape,cs,shift,strategy,padding_type,route", LAYER_CASES)
def test_layer_matches_flax(shape, cs, shift, strategy, padding_type, route):
    jl, params, tl, x = _layer_pair(*shape, cs, shift, strategy, padding_type, seed=9)
    assert tl.route(x.shape) == route
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tl(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", [LAYER_CASES[1], LAYER_CASES[5]], ids=["v4", "grouped_masked"])
def test_layer_input_gradient_matches_flax(case):
    shape, cs, shift, strategy, padding_type, _ = case
    jl, params, tl, x = _layer_pair(*shape, cs, shift, strategy, padding_type, seed=10)
    g = np.random.RandomState(11).randn(*x.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jl.apply({"params": params}, a) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tl.requires_grad_(False)(xt), [xt], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


PATTERN = "video_swin_2x2"   # at 5x4x4 / 2x4x4 it pads T, shifts, and keeps one v4 layer


@pytest.fixture(scope="module")
def pipelines():
    over = {"model": {"latent_model": {"self_pattern": PATTERN},
                      "align": {"model_args": {"block_attn_patterns": PATTERN}}}}
    jcfg = jax_load_config(jax_default_config, TINY)
    jcfg = type(jcfg).wrap(deep_merge(jcfg.to_dict(), over))
    ld, params = jax_build_pipeline(jcfg, with_alignment=True)
    jparams = {k: randomize_flax(params[k], seed) for k, seed in (("unet", 15), ("vae", 16),
                                                                    ("align", 17))}
    tcfg = load_config(prediff_default_config, TINY)
    tcfg = ConfigDict.wrap(deep_merge(tcfg.to_dict(), over))
    state = {"unet": flax_params_to_torch(build_unet(tcfg), jparams["unet"]),
             "vae": flax_params_to_torch(build_vae(tcfg), jparams["vae"]),
             "align": flax_params_to_torch(build_alignment_model(tcfg), jparams["align"])}
    predictor = PreDiffPredictor(tcfg, params=state, with_alignment=True, device="cpu")
    return ld, jparams, predictor


def _record_routes(model):
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, inp: seen.append(mod.route(inp[0].shape)))
             for m in model.modules() if isinstance(m, CuboidSelfAttentionLayer)]
    return seen, hooks


def test_tiny_unet_with_shifted_padded_windows_matches_jax(pipelines):
    ld, jparams, predictor = pipelines
    rs = np.random.RandomState(12)
    x, cond = rs.randn(2, 2, 4, 4, 8).astype(np.float32), rs.randn(2, 3, 4, 4, 8).astype(np.float32)
    t = np.array([1, 6], np.int32)
    want = np.asarray(ld.unet_apply({"params": jparams["unet"]}, jnp.asarray(x), jnp.asarray(t),
                                   jnp.asarray(cond)))
    seen, hooks = _record_routes(predictor.ld.unet)
    with torch.no_grad():
        got = predictor.ld.unet(torch.from_numpy(x), torch.from_numpy(t).long(),
                                torch.from_numpy(cond)).numpy()
    for h in hooks:
        h.remove()
    assert set(seen) == {"grouped", "grouped_masked"}
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_tiny_guided_chain_with_shifted_padded_windows_matches_jax(pipelines):
    ld, jparams, predictor = pipelines
    rs = np.random.RandomState(13)
    y = rs.rand(2, 3, 32, 32, 1).astype(np.float32)
    x_T = rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    avg = np.array([[0.3], [0.7]], np.float32)
    want = np.asarray(ld.sample(jparams["unet"], jparams["vae"], jax.random.PRNGKey(0),
                                jnp.asarray(y), align_params=jparams["align"],
                                x_T=jnp.asarray(x_T), temperature=0.0, timesteps=3,
                                use_alignment=True,
                                alignment_kwargs={"avg_x_gt": jnp.asarray(avg)}))
    seen, hooks = _record_routes(predictor.ld.alignment.model)
    got = predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T), temperature=0.0,
                              timesteps=3, use_alignment=True,
                              alignment_kwargs={"avg_x_gt": torch.from_numpy(avg)})
    for h in hooks:
        h.remove()
    # the alignment net's unshifted windows: v4 by pattern, at width 16 the einsum route
    assert set(seen) == {"einsum", "grouped_masked"}
    assert got.shape == want.shape == (2, 2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
