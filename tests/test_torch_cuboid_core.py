"""The round-1 cuboid attention ops (no model calls them): the per-cuboid core
and the whole layer "v3", the port's plain versions (what their wrappers run on
the CPU) against ``prediff_tpu/ops/pallas_attention.py``'s reference and its
interpret-mode kernels, f32 on both sides (CPU).  And the arithmetic of the
grouped core kernel they share with the grouped route, 3xTF32 on the tensor
cores, emulated in torch at the card tests' shapes; and ``LatentDiffusion``'s
device."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops.cuboid import compute_cuboid_self_attention_mask
from prediff_tpu.ops.pallas_attention import (cuboid_attention_reference,
                                              fused_cuboid_attention_layer as jax_layer_v3)
from prediff_tpu.ops.pallas_attention import fused_cuboid_attention as jax_core
from prediff_torch.diffusion.latent_diffusion import LatentDiffusion
from prediff_torch.diffusion.schedule import make_gaussian_schedule
from prediff_torch.ops.attention import (_tf32_product, cuboid_attention_layer_v3_plain,
                                         cuboid_attention_plain_core, fused_cuboid_attention,
                                         fused_cuboid_attention_layer_v3, grouped_attention_plain,
                                         grouped_attention_tf32, tf32_round)
from prediff_torch.ops.cuboid import compute_cuboid_self_attention_mask as torch_window_mask
from test_torch_kernels_cuda import CORE_CASES, GROUPED_CASES, V3_SHAPES

# f32 throughout on both sides; only the order of the sums differs
TOL = 1e-5

# tests/test_pallas_attention.py's shapes (B, nC, heads, vol, hc)
CORE_SHAPES = [(2, 16, 4, 13, 64), (1, 13, 4, 16, 64), (2, 8, 2, 32, 16)]
# tests/test_pallas_layer.py's v3 shapes (B, nC, vol, C, heads, cuboids_per_block)
LAYER_SHAPES = [(1, 16, 13, 64, 4, 16), (2, 13, 16, 64, 4, 16), (1, 8, 16, 32, 2, 4)]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= TOL * float(np.abs(want).max())


def _core_inputs(B, nC, H, vol, hc, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in [(B, nC, H, vol, hc)] * 3 + [(H, vol, vol)]]


def _shift_mask():
    """The JAX test's shifted-window mask: 32 cuboids of 32, some rows masked."""
    return compute_cuboid_self_attention_mask((8, 8, 8), (2, 4, 4), (1, 2, 2), ("l", "l", "l"),
                                              "ignore")


@pytest.mark.parametrize("shape", CORE_SHAPES)
def test_core_plain_matches_jax(shape):
    q, k, v, bias = _core_inputs(*shape, seed=0)
    scale = shape[-1] ** -0.5
    got = fused_cuboid_attention(*map(torch.from_numpy, (q, k, v, bias)), scale=scale)
    for want in (cuboid_attention_reference(*map(jnp.asarray, (q, k, v, bias)), scale=scale),
                 jax_core(*map(jnp.asarray, (q, k, v, bias)), scale=scale, interpret=True)):
        _close(got, want)


@pytest.mark.parametrize("reference", ["einsum", "interpret"])
def test_core_plain_with_mask_matches_jax(reference):
    mask = _shift_mask()
    nC, vol, _ = mask.shape
    q, k, v, bias = _core_inputs(2, nC, 4, vol, 32, seed=1)
    args = tuple(map(jnp.asarray, (q, k, v, bias)))
    want = (cuboid_attention_reference(*args, mask=jnp.asarray(mask), scale=32 ** -0.5)
            if reference == "einsum" else
            jax_core(*args, mask=jnp.asarray(mask), scale=32 ** -0.5, interpret=True))
    got = cuboid_attention_plain_core(*map(torch.from_numpy, (q, k, v, bias)),
                                      mask=torch.from_numpy(mask), scale=32 ** -0.5)
    _close(got, want)


def test_core_fully_masked_rows_are_zero():
    q, k, v, bias = map(torch.from_numpy, _core_inputs(1, 2, 2, 8, 4, seed=2))
    mask = torch.ones(2, 8, 8, dtype=torch.bool)
    mask[1, 3] = False
    out = fused_cuboid_attention(q, k, v, bias, mask, 0.5)
    assert torch.equal(out[:, 1, :, 3], torch.zeros_like(out[:, 1, :, 3]))
    assert out[:, 0].abs().min() > 0


def _layer_inputs(B, nC, vol, C, heads, seed=0):
    """The JAX test's draws, in its layout: w_qkv (C, 3C), w_proj (C, C)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, nC, vol, C).astype(np.float32)
    ln_scale, ln_bias = rng.randn(C).astype(np.float32), rng.randn(C).astype(np.float32)
    w_qkv = (rng.randn(C, 3 * C) * 0.05).astype(np.float32)
    bias = rng.randn(heads, vol, vol).astype(np.float32)
    w_proj = (rng.randn(C, C) * 0.05).astype(np.float32)
    b_proj = rng.randn(C).astype(np.float32)
    return x, ln_scale, ln_bias, w_qkv, bias, w_proj, b_proj


@pytest.mark.parametrize("shape", LAYER_SHAPES)
def test_layer_v3_plain_matches_interpret_kernel(shape):
    B, nC, vol, C, heads, G = shape
    x, ln_scale, ln_bias, w_qkv, bias, w_proj, b_proj = _layer_inputs(B, nC, vol, C, heads)
    scale = (C // heads) ** -0.5
    want = jax_layer_v3(*map(jnp.asarray, (x, ln_scale, ln_bias, w_qkv, bias, w_proj, b_proj)),
                        num_heads=heads, scale=scale, cuboids_per_block=G, interpret=True)
    # the port takes PyTorch layout: w_qkv (3C, C), w_proj (C, C) as (out, in)
    got = fused_cuboid_attention_layer_v3(
        *map(torch.from_numpy, (x, ln_scale, ln_bias, np.ascontiguousarray(w_qkv.T), bias,
                                np.ascontiguousarray(w_proj.T), b_proj)), heads, scale)
    _close(got, want)
    _close(cuboid_attention_layer_v3_plain(
        *map(torch.from_numpy, (x, ln_scale, ln_bias, np.ascontiguousarray(w_qkv.T), bias,
                                np.ascontiguousarray(w_proj.T), b_proj)), heads, scale), want)


def test_round1_ops_are_forward_only():
    """As the JAX kernels (no VJP): a call that would need a gradient raises,
    under no_grad it runs."""
    q, k, v, bias = map(torch.from_numpy, _core_inputs(1, 2, 2, 8, 4, seed=3))
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_cuboid_attention(q.requires_grad_(True), k, v, bias)
    with torch.no_grad():
        assert fused_cuboid_attention(q, k, v, bias).shape == q.shape
    layer = [torch.from_numpy(a) for a in _layer_inputs(1, 2, 8, 16, 2)]
    layer[3] = layer[3].T.contiguous().requires_grad_(True)
    layer[5] = layer[5].T.contiguous()
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_cuboid_attention_layer_v3(*layer, 2, 0.5)
    with torch.no_grad():
        assert fused_cuboid_attention_layer_v3(*layer, 2, 0.5).shape == layer[0].shape


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0e-30])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.0e-30])
    got = tf32_round(x)
    assert torch.equal(got[:5], want[:5])   # ties away from zero
    assert abs(float(got[5]) / 3.0e-30 - 1) <= 2.0 ** -11
    bits = got.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())


# the card tests' grouped (head-major) and round-1 (cuboid-major) shapes
TF32_CASES = ([("grouped", s, w) for s, w in GROUPED_CASES]
              + [("cuboid", s, w) for s, w in CORE_CASES])


def _tf32_errors(layout, shape, window):
    """The 3-pass and 1-pass emulations' worst error against the f32 plain
    version as a share of the output's max, and the 3-pass output
    (head-major)."""
    rng = np.random.RandomState(sum(shape))
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)) for _ in range(3))
    heads, vol, hc = (shape[1] if layout == "grouped" else shape[2]), shape[3], shape[4]
    bias = torch.from_numpy((0.5 * rng.randn(heads, vol, vol)).astype(np.float32))
    mask = None if window is None else torch.from_numpy(torch_window_mask(
        window[0], window[1], window[2], ("l", "l", "l"), window[3]))
    if layout == "cuboid":   # the same function on (B, cuboids, heads, vol, hc)
        want = cuboid_attention_plain_core(q, k, v, bias, mask, hc ** -0.5)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    else:
        want = grouped_attention_plain(q, k, v, bias, mask, hc ** -0.5)
    errors, out = {}, None
    for passes in (3, 1):
        got = grouped_attention_tf32(q, k, v, bias, mask, hc ** -0.5, passes=passes)
        diff = (got.transpose(1, 2) if layout == "cuboid" else got) - want
        errors[passes] = float(diff.abs().max()) / float(want.abs().max())
        out = got if out is None else out
    return errors, out, mask


@pytest.mark.parametrize("layout,shape,window", TF32_CASES)
def test_core_in_3xtf32_meets_the_bar_and_one_pass_does_not(layout, shape, window):
    """The kernel's 3xTF32 products stay within the core's 1e-5 of the
    output's max against the f32 plain version; a single TF32 pass does not."""
    errors, got, mask = _tf32_errors(layout, shape, window)
    assert errors[3] <= TOL and errors[1] > TOL, errors
    if mask is not None and (~mask.any(-1)).any():   # fully masked rows stay exactly 0
        assert bool((got[:, :, ~mask.any(-1)] == 0).all())


def _v3_errors(shape):
    """The round-1 layer with its two products on TF32 parts (3 passes, as
    ``tf32_gemm_kernel``; or 1) around the core's 3xTF32 arithmetic: the
    worst error against the f32 plain version as a share of the output's
    max, for each number of passes, at the card tests' v3 shapes."""
    B, nC, vol, C = shape
    heads = 4 if C > 32 else 2
    hc, rng = C // heads, np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    ln_w = torch.from_numpy((1.0 + 0.1 * rng.randn(C)).astype(np.float32))
    ln_b = torch.from_numpy((0.1 * rng.randn(C)).astype(np.float32))
    w_qkv = torch.from_numpy((rng.randn(3 * C, C) / C ** 0.5).astype(np.float32))
    bias = torch.from_numpy((0.5 * rng.randn(heads, vol, vol)).astype(np.float32))
    w_proj = torch.from_numpy((rng.randn(C, C) / C ** 0.5).astype(np.float32))
    b_proj = torch.from_numpy((0.1 * rng.randn(C)).astype(np.float32))
    want = cuboid_attention_layer_v3_plain(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads,
                                           hc ** -0.5)
    ln = torch.nn.functional.layer_norm(x, (C,), ln_w, ln_b, 1e-5).reshape(-1, C)
    errors = {}
    for passes in (3, 1):
        qkv = _tf32_product("mk,nk->mn", ln, w_qkv, passes)
        q, k, v = qkv.reshape(B, nC, vol, 3, heads, hc).permute(3, 0, 4, 1, 2, 5)
        o = grouped_attention_tf32(q, k, v, bias, None, hc ** -0.5, passes=3)
        o = o.permute(0, 2, 3, 1, 4).reshape(-1, C)
        got = (_tf32_product("mk,nk->mn", o, w_proj, passes) + b_proj).reshape(shape)
        errors[passes] = float((got - want).abs().max()) / float(want.abs().max())
    return errors


@pytest.mark.parametrize("shape", V3_SHAPES)
def test_layer_v3_products_in_3xtf32_meet_the_bar_and_one_pass_does_not(shape):
    """The v3 layer's LN + QKV and projection products in 3xTF32 on the
    tensor cores stay within the round-1 bar, 1e-5 of the output's max,
    against the f32 plain version; one TF32 pass does not."""
    errors = _v3_errors(shape)
    assert errors[3] <= TOL and errors[1] > TOL, errors


def _latent_diffusion(device):
    schedule = make_gaussian_schedule(timesteps=10)
    return LatentDiffusion(torch.nn.Identity(), torch.nn.Identity(), schedule,
                           latent_shape=(2, 4, 4, 1), device=device)


def test_latent_diffusion_defaults_to_the_card(monkeypatch):
    """``device=None`` means the card, as at every entry point: without one
    it raises rather than carry on on the CPU; ``"cpu"`` asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        _latent_diffusion(None)
    ld = _latent_diffusion("cpu")
    assert ld.device == torch.device("cpu")
    assert ld.schedule.betas.device == torch.device("cpu")


if __name__ == "__main__":   # the errors themselves: python tests/test_torch_cuboid_core.py
    for layout, shape, window in TF32_CASES:
        errors = _tf32_errors(layout, shape, window)[0]
        print(layout, shape, "masked" if window else "", {p: f"{e:.2e}" for p, e in errors.items()})
    for shape in V3_SHAPES:
        print("v3", shape, {p: f"{e:.2e}" for p, e in _v3_errors(shape).items()})
