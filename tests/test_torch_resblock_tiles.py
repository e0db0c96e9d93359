"""What the whole resblock's kernels (``csrc/resblock.cu``) are handed, on the
CPU: the tiles of its four convs (``ops/conv3d.conv_tiles``, the standalone
conv's kernel) cover every token box of the alignment net's shapes once, and
its GroupNorm passes' clusters (``ops/resblock.gn_tiles``) every token; a
torch emulation of the block's order of arithmetic (the convs' implicit GEMM
by those boxes and cluster splits, h1, h2, h3, dh3, dv and dh1 rounded to
bf16, GN2's statistics from the bf16 h2, every sum f32) against the JAX
package's Pallas kernels in interpret mode; and the bf16 weight layouts the
kernels read, made once per parameter version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_conv_tiles import _box_tokens
from test_torch_conv_tiles import _emulate as _conv
from test_torch_resblock import GROUPS, SHAPE, _cotangent, _inputs, _jax_args, _torch_args

from prediff_tpu.ops import pallas_resblock
from prediff_torch.ops import conv3d
from prediff_torch.ops.conv3d import weight_layout
from prediff_torch.ops.groupnorm import GN_SMEM_CAP
from prediff_torch.ops.resblock import _gn_silu, _gn_silu_bwd, gn_tiles, supports

# the alignment net's stage blocks at B = 1 and 2, and a 64-channel block
SHAPES = [(1, 6, 16, 16, 128), (1, 6, 8, 8, 256), (2, 6, 16, 16, 128), (2, 6, 8, 8, 256),
          (2, 3, 4, 5, 64)]
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4


@pytest.mark.parametrize("shape", SHAPES)
def test_conv_tiles_cover_every_token_box_once(shape):
    B, T, H, W, C = shape
    assert supports(C, 32)
    plan = conv3d.conv_tiles(B, T, H, W, C, C)
    seen = np.zeros((B, T, H, W), dtype=np.int64)
    for m in range(plan.m_tiles):
        b, t, h, w, inside = _box_tokens(plan, m)
        assert 0 <= b < B
        np.add.at(seen, (b, t[inside], h[inside], w[inside]), 1)
    assert (seen == 1).all()
    assert plan.n_tile * plan.n_tiles == C and plan.n_tile in (64, 128, 256)
    assert [i for r in range(plan.splits) for i in plan.split_slices(r)] == list(range(plan.slices))
    assert plan.splits in conv3d.SPLITS
    blocks = plan.m_tiles * plan.n_tiles * plan.splits
    assert blocks <= conv3d.SMS or plan.splits == 1
    assert blocks >= conv3d.SMS // 2 or plan.n_tile == 64   # half the SMs at least


@pytest.mark.parametrize("shape", SHAPES)
def test_groupnorm_clusters_cover_every_token_once(shape):
    """Each GroupNorm pass: a cluster of ranks per (group, sample) whose
    token ranges cover the volume once, the backward's two f32 tiles within
    a block's shared memory, at least 128 blocks (or the largest cluster);
    a group past 8 ranks' shared memory takes the one-block kernels."""
    B, T, H, W, C = shape
    N, groups = T * H * W, 32
    ranks, tpr = gn_tiles(B, N, C, groups)
    assert ranks in (1, 2, 4, 8)
    covered = [n for r in range(ranks) for n in range(r * tpr, min(N, (r + 1) * tpr))]
    assert covered == list(range(N))
    assert 8 * tpr * (C // groups) <= GN_SMEM_CAP - 2048
    assert B * groups * ranks >= 128 or ranks == 8
    assert gn_tiles(1, 240000, 64, 32) == (0, 0)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _emulate_fwd(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups, eps=1e-5):
    """(out, h2): h1 = bf16(silu(GN1 x)); h2 = bf16(conv1(h1) + b1); h3 =
    bf16(silu(GN2(h2 + emb))); out = (conv2(h3) + b2) + x, each conv the
    kernel's tiles on the cached bf16 layouts."""
    B, T, H, W, C = x.shape
    plan = conv3d.conv_tiles(B, T, H, W, C, C)
    h1 = _bf(_gn_silu(x, g1s, g1b, groups, eps))
    h2 = _bf(_conv(h1, weight_layout(k1), b1, plan))
    h3 = _bf(_gn_silu(h2, g2s, g2b, groups, eps, emb))
    return _conv(h3, weight_layout(k2), b2, plan) + x, h2


def _emulate_bwd(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g, groups, eps=1e-5):
    """(dx, demb): dh3 = bf16(conv2^T(bf16 g)); dv = the GN2 / SiLU backward
    at h2 + emb, demb its f32 sum, stored bf16; dh1 = bf16(conv1^T(dv)); dx =
    the GN1 / SiLU backward + g."""
    B, T, H, W, C = x.shape
    plan = conv3d.conv_tiles(B, T, H, W, C, C)
    dh3 = _bf(_conv(g, weight_layout(k2, dx=True), None, plan))
    dv = _gn_silu_bwd(h2 + emb[:, None, None, None, :], dh3, g2s, g2b, groups, eps)
    dh1 = _bf(_conv(_bf(dv), weight_layout(k1, dx=True), None, plan))
    return _gn_silu_bwd(x, dh1, g1s, g1b, groups, eps) + g, dv.sum(dim=(1, 2, 3))


def _close(name, a, b):
    a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
    err, scale_b = np.abs(a - b), max(1.0, np.abs(b).max())
    assert err.max() <= TOL_BF16 * scale_b, (name, err.max(), scale_b)
    assert err.mean() <= MEAN_TOL_BF16 * scale_b, (name, err.mean(), scale_b)


def test_emulated_block_matches_the_interpret_kernels():
    a, g = _inputs(4), _cotangent(5)
    args = _jax_args(a)
    out, h2 = pallas_resblock.fused_resblock(*args, groups=GROUPS, mxu_dtype_name="bfloat16",
                                             interpret=True)
    x, emb, k1, _, k2, _, g1s, g1b, g2s, g2b = args
    dx, demb = pallas_resblock._fused_resblock_bwd(
        x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, jnp.asarray(g), groups=GROUPS,
        mxu_dtype_name="bfloat16", interpret=True)
    h2 = pallas_resblock._crop_rows(h2.astype(jnp.float32), *SHAPE[1:4])
    t = _torch_args(a)
    got_out, got_h2 = _emulate_fwd(*t, GROUPS)
    _close("out", got_out, out)
    _close("h2", got_h2, h2)
    x, emb, k1, _, k2, _, g1s, g1b, g2s, g2b = t
    got_dx, got_demb = _emulate_bwd(x, emb, k1, k2, g1s, g1b, g2s, g2b, got_h2,
                                    torch.from_numpy(g), GROUPS)
    _close("dx", got_dx, dx)
    _close("demb", got_demb, demb)


def test_the_layouts_are_made_once_per_parameter_version():
    """Both kernels' layouts of a weight (the forward's and the flipped
    transpose) come from the cache: the same tensors on every call, also
    after ``requires_grad_(False)`` (a frozen model's guidance shift); a
    view of the same storage shares the version counter, so an in-place
    update makes new layouts for both, with the new values."""
    k = torch.randn(64, 64, 3, 3, 3, requires_grad=True)
    first = (weight_layout(k), weight_layout(k, dx=True))
    assert weight_layout(k) is first[0] and weight_layout(k, dx=True) is first[1]
    k.requires_grad_(False)
    assert weight_layout(k) is first[0] and weight_layout(k, dx=True) is first[1]
    view = k.detach()
    assert torch.equal(weight_layout(view), first[0])
    with torch.no_grad():
        k.mul_(0.5)
    now = (weight_layout(k), weight_layout(k, dx=True))
    assert now[0] is not first[0] and now[1] is not first[1]
    want = conv3d.conv_weight(k).transpose(1, 2).to(torch.bfloat16)
    assert torch.equal(now[0], want) and torch.equal(weight_layout(view), want)
    assert weight_layout(k) is now[0]
