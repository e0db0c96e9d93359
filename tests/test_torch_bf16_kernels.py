"""The kernels' plain versions on bf16 tensors (what the wrappers run on the
CPU for the alignment net's bf16 copy) against the JAX package's
``*_reference`` functions on the same bf16 inputs, each forward and its input
gradient (``jax.vjp`` of the reference): GroupNorm+SiLU, the FFN, the axial
attention layer, the resblock and the 3x3x3 conv.  A plain version widens
its bf16 inputs to f32, computes as in f32 and rounds its result to bf16, as
the kernels' bf16 forms do; held within 1.6e-2 of the output's largest
magnitude (two bf16 roundings of it).  The bf16 forms themselves are held to
these plain versions on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import cuboid as jax_cuboid
from prediff_tpu.ops import pallas_attention, pallas_conv3d, pallas_ffn, pallas_groupnorm
from prediff_tpu.ops import pallas_resblock
from prediff_torch.ops.attention import (axial_cuboid_size, fused_axial_attention,
                                         fused_axial_attention_bwd_dx)
from prediff_torch.ops.conv3d import conv3x3x3_dx, fused_conv3x3x3
from prediff_torch.ops.ffn import fused_ffn, fused_ffn_bwd_dx
from prediff_torch.ops.groupnorm import fused_groupnorm_silu, fused_groupnorm_silu_bwd_full
from prediff_torch.ops.resblock import fused_resblock_bwd, fused_resblock_fwd

TOL = 1.6e-2          # of the output's max |value|
BF = torch.bfloat16


def _bf16(*arrays):
    """Each array rounded to bf16: (the jnp array, the torch tensor)."""
    out = []
    for a in arrays:
        j = jnp.asarray(a, jnp.bfloat16)
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF)))
    return out


def _close(got: torch.Tensor, want):
    assert got.dtype == BF
    got, want = got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _t(pair):
    return pair[1]


def _j(pair):
    return pair[0]


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
def test_groupnorm_silu_bf16(grad):
    rs = np.random.RandomState(0)
    B, N, C, groups = 2, 48, 64, 32
    x, w, b, emb, g = _bf16(rs.randn(B, N, C) * 2 + 1, 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C),
                            rs.randn(B, C), rs.randn(B, N, C))

    def ref(xx):
        return pallas_groupnorm.fused_groupnorm_silu_reference(xx, _j(w), _j(b), _j(emb),
                                                               groups=groups)

    if not grad:
        _close(fused_groupnorm_silu(_t(x), _t(w), _t(b), _t(emb), groups), ref(_j(x)))
    else:
        _, vjp = jax.vjp(lambda xx: ref(xx).astype(jnp.bfloat16), _j(x))
        dx = fused_groupnorm_silu_bwd_full(_t(x), _t(g), _t(w), _t(b), _t(emb), groups)[0]
        _close(dx, vjp(_j(g))[0])


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
def test_ffn_bf16(grad):
    rs = np.random.RandomState(1)
    M, C, hid = 40, 128, 512
    x, s, sb, w1, b1, w2, b2, g = _bf16(
        rs.randn(M, C) * 0.5, 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C),
        rs.randn(C, hid) / np.sqrt(C), 0.1 * rs.randn(hid), rs.randn(hid, C) / np.sqrt(hid),
        0.1 * rs.randn(C), rs.randn(M, C))

    def ref(xx):
        return pallas_ffn.fused_ffn_reference(xx, _j(s), _j(sb), _j(w1), _j(b1), _j(w2), _j(b2))

    tw1, tw2 = _t(w1).t().contiguous(), _t(w2).t().contiguous()   # flax (in, out) -> torch
    if not grad:
        _close(fused_ffn(_t(x), _t(s), _t(sb), tw1, _t(b1), tw2, _t(b2)), ref(_j(x)))
    else:
        _, vjp = jax.vjp(lambda xx: ref(xx).astype(jnp.bfloat16), _j(x))
        _close(fused_ffn_bwd_dx(_t(x), _t(g), _t(s), _t(sb), tw1, _t(b1), tw2), vjp(_j(g))[0])


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
@pytest.mark.parametrize("axis", [0, 2])
def test_axial_attention_bf16(grad, axis):
    rs = np.random.RandomState(2 + axis)
    shape, heads = (1, 3, 4, 5, 64), 4
    C, vol = shape[-1], shape[1 + axis]
    x, s, sb, wq, bias, wp, bp, g = _bf16(
        rs.randn(*shape), 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C),
        rs.randn(C, 3 * C) / np.sqrt(C), 0.5 * rs.randn(heads, vol, vol),
        rs.randn(C, C) / np.sqrt(C), 0.1 * rs.randn(C), rs.randn(*shape))
    scale = (C // heads) ** -0.5
    cs = axial_cuboid_size(shape, axis)

    def ref(xx):
        xr = jax_cuboid.cuboid_reorder(xx, cs, ("l", "l", "l"))
        out = pallas_attention.cuboid_layer_attention_reference(
            xr, _j(s), _j(sb), _j(wq), _j(bias), _j(wp), _j(bp), heads, scale)
        return jax_cuboid.cuboid_reorder_reverse(out, cs, ("l", "l", "l"), shape[1:4])

    # the layer gathers its relative bias in f32 for the kernels (exact from bf16)
    targs = (_t(s), _t(sb), _t(wq).t().contiguous(), _t(bias).float(),
             _t(wp).t().contiguous())
    if not grad:
        _close(fused_axial_attention(_t(x), axis, *targs, _t(bp), heads, scale), ref(_j(x)))
    else:
        _, vjp = jax.vjp(lambda xx: ref(xx).astype(jnp.bfloat16), _j(x))
        _close(fused_axial_attention_bwd_dx(_t(x), _t(g), axis, *targs, heads, scale),
               vjp(_j(g))[0])


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
def test_resblock_bf16(grad):
    rs = np.random.RandomState(4)
    B, T, H, W, C, groups = 1, 2, 4, 4, 64, 32
    x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, g = _bf16(
        rs.randn(B, T, H, W, C) * 0.5, rs.randn(B, C) * 0.3,
        rs.randn(3, 3, 3, C, C) / np.sqrt(27 * C), 0.1 * rs.randn(C),
        rs.randn(3, 3, 3, C, C) / np.sqrt(27 * C), 0.1 * rs.randn(C),
        1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C), 1 + 0.1 * rs.randn(C), 0.1 * rs.randn(C),
        rs.randn(B, T, H, W, C))
    rest = [_j(a) for a in (k1, b1, k2, b2, g1s, g1b, g2s, g2b)]

    def ref(xx):
        return pallas_resblock.resblock_reference(xx, _j(emb), *rest, groups=groups)

    tk1, tk2 = (_t(k).permute(4, 3, 0, 1, 2).contiguous() for k in (k1, k2))
    vecs = [_t(a) for a in (g1s, g1b, g2s, g2b)]
    out, h2 = fused_resblock_fwd(_t(x), _t(emb), tk1, _t(b1), tk2, _t(b2), *vecs, groups)
    if not grad:
        _close(out, ref(_j(x)))
    else:
        _, vjp = jax.vjp(lambda xx: ref(xx).astype(jnp.bfloat16), _j(x))
        dx, _ = fused_resblock_bwd(_t(x), _t(emb), tk1, tk2, *vecs, h2, _t(g), groups)
        _close(dx, vjp(_j(g))[0])


@pytest.mark.parametrize("grad", [False, True], ids=["fwd", "dx"])
def test_conv3x3x3_bf16(grad):
    rs = np.random.RandomState(5)
    B, T, H, W, C, OC = 1, 3, 4, 4, 64, 128
    x, k, b, g = _bf16(rs.randn(B, T, H, W, C), rs.randn(3, 3, 3, C, OC) / np.sqrt(27 * C),
                       0.1 * rs.randn(OC), rs.randn(B, T, H, W, OC))

    def ref(xx):
        return pallas_conv3d.conv3x3x3_reference(xx, _j(k), _j(b))

    tk = _t(k).permute(4, 3, 0, 1, 2).contiguous()
    if not grad:
        _close(fused_conv3x3x3(_t(x), tk, _t(b)), ref(_j(x)))
    else:
        _, vjp = jax.vjp(lambda xx: ref(xx).astype(jnp.bfloat16), _j(x))
        _close(conv3x3x3_dx(_t(g), tk), vjp(_j(g))[0])
