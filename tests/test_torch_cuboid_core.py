"""The round-1 cuboid attention ops (no model calls them): the per-cuboid core
and the whole layer "v3", the port's plain versions (what their wrappers run on
the CPU) against ``prediff_tpu/ops/pallas_attention.py``'s reference and its
interpret-mode kernels, f32 on both sides (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops.cuboid import compute_cuboid_self_attention_mask
from prediff_tpu.ops.pallas_attention import (cuboid_attention_reference,
                                              fused_cuboid_attention_layer as jax_layer_v3)
from prediff_tpu.ops.pallas_attention import fused_cuboid_attention as jax_core
from prediff_torch.ops.attention import (cuboid_attention_layer_v3_plain,
                                         cuboid_attention_plain_core, fused_cuboid_attention,
                                         fused_cuboid_attention_layer_v3)

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
