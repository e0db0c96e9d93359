"""bf16 parameters beyond the axial UNet (CPU): guidance with a bf16
alignment net, the bf16 forms' plain versions of the general cuboid layer,
its input gradient and the grouped core, and a ``video_swin_2x2`` UNet on
bf16 parameters, each held to the JAX package.

Guidance: the mixes of tests/test_torch_bf16_guidance.py with the net's
parameters cast to bf16 (the alignment net of tests/test_torch_alignment.py,
at the kernels' widths), plus f32 guidance on an f32 carry, where JAX runs
the bf16 tree promoted to f32 (the port: the net's f32 copy): rel-L2 5e-2 and
cosine 0.99 against ``get_mean_shift``, JAX's dtype.  The plain versions on
bf16 inputs (widened, the f32 function, the output rounded once) against the
JAX ``cuboid_layer_attention_reference`` (its dx by ``jax.vjp``) and
``grouped_attention_reference`` on the same bf16 values, with and without the
window mask: the f32 bar (1e-5) plus one bf16 ulp of the output's max.  The
swin UNet (shifted and padded windows: the grouped core with and without the
mask, its bias in f32) one forward on a bf16 carry, by the rule of
tests/test_torch_bf16_params.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_alignment import KW
from test_torch_bf16_params import ACCURACY_SHARE, TINY, seeded_tree

from prediff_tpu.config import deep_merge
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.diffusion.knowledge_alignment import KnowledgeAlignment as JaxAlignment
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.models.alignment import NoisyCuboidTransformerEncoder as JaxEncoder
from prediff_tpu.ops import pallas_attention
from prediff_tpu.ops.cuboid import compute_cuboid_self_attention_mask
from prediff_tpu.utils.precision import cast_to_bf16 as jax_cast_to_bf16
from prediff_torch.config import ConfigDict, load_config, prediff_default_config
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.factory import build_unet
from prediff_torch.models.alignment import NoisyCuboidTransformerEncoder
from prediff_torch.ops.attention import (cuboid_attention_bwd_dx_plain, cuboid_attention_plain,
                                         fused_cuboid_attention_grouped)
from prediff_torch.utils.convert import flax_params_to_torch
from prediff_torch.utils.precision import cast_to_bf16

REL_L2, MIN_COSINE = 5e-2, 0.99
SWIN_FORWARD_TOL = 3e-2
TOL_F32 = 1e-5
AVG = np.array([[0.4]], np.float32)
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _assert_bf16_close(got, want):
    """The f32 bar plus one bf16 ulp of the output's max (both round an f32
    result once; the roundings may fall apart)."""
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    g, w = _f32(got), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert (np.abs(g - w) <= TOL_F32 + TOL_F32 * np.abs(w) + ulp).all(), np.abs(g - w).max()


@pytest.fixture(scope="module")
def nets():
    jnet = JaxEncoder(attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0, ffn_activation="gelu",
                      readout_seq=True, **KW)
    rs = np.random.RandomState(11)
    zt = (rs.randn(1, 2, 8, 8, 64) * 0.5).astype(np.float32)
    t = np.array([7], np.int32)
    params = jax_cast_to_bf16(seeded_tree(jnet, 12, jnp.asarray(zt), jnp.asarray(t)))
    tnet = NoisyCuboidTransformerEncoder(**KW).to(BF16).eval().requires_grad_(False)
    tnet.load_state_dict(flax_params_to_torch(tnet, params))
    return jnet, params, tnet, zt, t


# (guidance dtype, carry dtype, the shift's dtype, whether the net runs on its f32 copy)
MIXES = {"guidance_bf16": ("bfloat16", "float32", "float32", False),
         "carry_bf16": ("float32", "bfloat16", "bfloat16", True),
         "both_bf16": ("bfloat16", "bfloat16", "float32", False),
         "both_f32": ("float32", "float32", "float32", True)}


@pytest.mark.parametrize("mix", list(MIXES))
def test_mean_shift_of_a_bf16_net_matches_jax(nets, mix):
    jnet, params, tnet, zt, t = nets
    guidance, carry, out_dtype, promoted = MIXES[mix]
    jz = jnp.asarray(zt, jnp.dtype(carry))
    jka = JaxAlignment(params=params, apply_fn=jnet.apply, compute_dtype=guidance,
                       guide_scale=2.0)
    want = jax.jit(jka.get_mean_shift)(jz, jnp.asarray(t), jnp.asarray(AVG))
    ka = KnowledgeAlignment(tnet, guide_scale=2.0, compute_dtype=guidance)
    tz = torch.from_numpy(_f32(jz).copy()).to(getattr(torch, carry))
    with torch.no_grad():
        got = ka.get_mean_shift(tz, torch.from_numpy(t).long(), torch.from_numpy(AVG))
    assert str(want.dtype) == out_dtype and got.dtype == getattr(torch, out_dtype)
    g, w = _f32(got).ravel().astype(np.float64), np.asarray(want, np.float64).ravel()
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= REL_L2
    assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= MIN_COSINE
    # the net ran on its f32 copy where the promotion widens it, else on itself
    copy = ka._low.copy
    assert (copy is not None) == promoted
    assert ka.modules(tz.dtype)[-1] is (copy if promoted else tnet)
    if promoted:
        assert all(p.dtype == torch.float32 for p in copy.parameters())
        assert ka.tracked() == [tnet, copy]


def _layer_inputs(shape, heads, seed):
    """bf16 x (B, cuboids, vol, C) and weights (flax layout), the bias f32, as
    the layer hands them to its kernel."""
    rs = np.random.RandomState(seed)
    B, nC, vol, C = shape
    bf = jnp.bfloat16
    return (jnp.asarray(rs.randn(*shape), bf), jnp.asarray(1.0 + 0.1 * rs.randn(C), bf),
            jnp.asarray(0.1 * rs.randn(C), bf), jnp.asarray(rs.randn(C, 3 * C) / np.sqrt(C), bf),
            jnp.asarray(0.5 * rs.randn(heads, vol, vol), jnp.float32),
            jnp.asarray(rs.randn(C, C) / np.sqrt(C), bf), jnp.asarray(0.1 * rs.randn(C), bf))


def _torch(a) -> torch.Tensor:
    t = torch.from_numpy(_f32(a).copy())
    return t if a.dtype == jnp.float32 else t.to(BF16)


@pytest.mark.parametrize("shape", [(2, 3, 64, 64)])
def test_general_layer_plain_versions_on_bf16_match_jax(shape):
    heads, scale = 4, (shape[3] // 4) ** -0.5
    x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj = _layer_inputs(shape, heads, shape[1])
    g = jnp.asarray(np.random.RandomState(9).randn(*shape), jnp.bfloat16)

    def ref(x):
        return pallas_attention.cuboid_layer_attention_reference(
            x, ln_s, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)

    want, vjp = jax.vjp(ref, x)
    targs = [_torch(a) for a in (ln_s, ln_b)] + [_torch(w_qkv).T.contiguous(), _torch(bias),
                                                 _torch(w_proj).T.contiguous()]
    got = cuboid_attention_plain(_torch(x), *targs, _torch(b_proj), heads, scale)
    _assert_bf16_close(got, want)
    dx = cuboid_attention_bwd_dx_plain(_torch(x), _torch(g), *targs, heads, scale)
    _assert_bf16_close(dx, vjp(g)[0])


@pytest.mark.parametrize("window", [None, ((5, 6, 6), (2, 4, 4), (0, 0, 0), "ignore"),
                                    ((2, 16, 16), (1, 8, 8), (0, 4, 4), "zeros")])
def test_grouped_plain_version_on_bf16_matches_jax(window):
    rs = np.random.RandomState(3)
    heads, hc = 2, 16
    mask = None
    if window is None:
        nC, vol = 3, 20
    else:
        mask = compute_cuboid_self_attention_mask(window[0], window[1], window[2],
                                                  ("l", "l", "l"), window[3])
        nC, vol = mask.shape[:2]
    q, k, v = (jnp.asarray(rs.randn(1, heads, nC, vol, hc), jnp.bfloat16) for _ in range(3))
    bias = jnp.asarray(0.5 * rs.randn(heads, vol, vol), jnp.float32)
    jm = None if mask is None else jnp.asarray(mask)
    # the JAX kernel widens q, k, v and returns their dtype: its reference on the widened values
    want = pallas_attention.grouped_attention_reference(
        *(a.astype(jnp.float32) for a in (q, k, v)), bias, mask=jm, scale=hc ** -0.5)
    got = fused_cuboid_attention_grouped(*(_torch(a) for a in (q, k, v)), _torch(bias),
                                         None if mask is None else torch.from_numpy(mask),
                                         hc ** -0.5)
    _assert_bf16_close(got, want.astype(jnp.bfloat16))


def test_swin_unet_forward_on_bf16_parameters_matches_jax():
    # at 5x4x4 / 2x4x4 it pads T and shifts: grouped cores with and without the mask
    override = {"model": {"latent_model": {"self_pattern": "video_swin_2x2"}}}
    jcfg = jax_load_config(jax_default_config, TINY)
    jcfg = type(jcfg).wrap(deep_merge(jcfg.to_dict(), override))
    tcfg = ConfigDict.wrap(deep_merge(load_config(prediff_default_config, TINY).to_dict(),
                                      override))
    d = tcfg.model.diffusion
    rs = np.random.RandomState(4)
    x = rs.randn(2, *d.latent_shape).astype(np.float32)
    c = rs.randn(2, *d.latent_cond_shape).astype(np.float32)
    t = np.array([2, 5], np.int32)
    jmodel = jax_build_unet(jcfg)
    params = jax_cast_to_bf16(seeded_tree(jmodel, 8, jnp.asarray(x[:1]), jnp.asarray(t[:1]),
                                          jnp.asarray(c[:1])))
    apply = jax.jit(jmodel.apply)
    jax16 = apply({"params": params}, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                  jnp.asarray(c, jnp.bfloat16))
    jax32 = apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    unet = cast_to_bf16(build_unet(tcfg)).eval().requires_grad_(False)
    unet.load_state_dict(flax_params_to_torch(unet, params))
    routes = {layer.route((2, *shape[:3], shape[3])) for shape, blk in
              zip(unet.mem_shapes, [b[0] for b in unet.down_self_blocks]) for layer in blk.attn_l}
    assert routes & {"grouped", "grouped_masked"}
    got = unet(torch.from_numpy(x).to(BF16), torch.from_numpy(t).long(),
               torch.from_numpy(c).to(BF16))
    assert got.dtype == BF16
    g, w16, w32 = _f32(got), _f32(jax16), _f32(jax32)
    assert _rel(g, w16) <= SWIN_FORWARD_TOL, _rel(g, w16)
    assert _rel(g, w32) <= ACCURACY_SHARE * _rel(w16, w32), (_rel(g, w32), _rel(w16, w32))
