"""The port's CUDA kernels against their plain PyTorch versions on the card,
at the shapes the v1 UNet and alignment net give them, and autograd through
every wrapper.  Every test needs a CUDA device and skips without one.  This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from prediff_torch.ops.attention import (axial_attention_bwd_dx_plain,
                                         axial_attention_bwd_full_plain, axial_attention_plain,
                                         fused_axial_attention, fused_axial_attention_bwd_dx,
                                         fused_axial_attention_bwd_full,
                                         fused_axial_attention_dropout,
                                         fused_axial_attention_dropout_bwd_full)
from prediff_torch.ops.attention import (cuboid_attention_bwd_dx_plain,
                                         cuboid_attention_bwd_full_plain,
                                         cuboid_attention_dropout_bwd_full_plain,
                                         cuboid_attention_dropout_plain, cuboid_attention_plain,
                                         fused_cuboid_attention_grouped,
                                         fused_cuboid_attention_layer,
                                         fused_cuboid_attention_layer_bwd_dx,
                                         fused_cuboid_attention_layer_bwd_full,
                                         fused_cuboid_attention_layer_dropout,
                                         fused_cuboid_attention_layer_dropout_bwd_full,
                                         grouped_attention_plain)
from prediff_torch.ops.attention import (cuboid_attention_layer_v3_plain,
                                         cuboid_attention_plain_core, fused_cuboid_attention,
                                         fused_cuboid_attention_layer_v3)
from prediff_torch.ops.conv3d import (conv3x3x3_dx, conv3x3x3_dx_plain, conv3x3x3_forward,
                                      conv3x3x3_plain, fused_conv3x3x3, weight_layout)
from prediff_torch.ops.cuboid import compute_cuboid_self_attention_mask
from prediff_torch.ops.dropout import keep_mask
from prediff_torch.ops.ffn import (ffn_bwd_dx_plain, ffn_bwd_full_plain, ffn_dropout_bwd_full_plain,
                                   ffn_dropout_plain, ffn_plain, fused_ffn, fused_ffn_bwd_dx,
                                   fused_ffn_bwd_full, fused_ffn_dropout,
                                   fused_ffn_dropout_bwd_full)
from prediff_torch.ops.groupnorm import (fused_groupnorm_silu, fused_groupnorm_silu_bwd_full,
                                         groupnorm_silu_bwd_full_plain, groupnorm_silu_plain)
from prediff_torch.ops.resblock import (fused_resblock, fused_resblock_bwd, fused_resblock_fwd,
                                        resblock_bwd_plain, resblock_plain)

pytestmark = pytest.mark.cuda

# GN: f32 both ways, another sum order.  FFN / attention: bf16 operands
# rounded at the same points on both sides; a 1-ulp f32 difference before a
# rounding can flip one operand, which moves a few outputs by up to ~1e-2
# while the mean error stays ~1e-5.
TOL_GN = 1e-4
TOL_BF16 = 2e-2
MEAN_TOL_BF16 = 1e-4


@pytest.fixture
def dev():
    """The card; decided per test, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.manual_seed(0)
    return torch.device("cuda")


def _close_bf16(got, want):
    err = (got - want).abs()
    assert err.max().item() <= TOL_BF16, err.max().item()
    assert err.mean().item() <= MEAN_TOL_BF16, err.mean().item()


@pytest.mark.parametrize("N,C,groups", [(3328, 256, 32), (832, 512, 32), (3328, 65, 65)])
@pytest.mark.parametrize("with_emb", [False, True])
def test_groupnorm_kernel_matches_plain(dev, N, C, groups, with_emb):
    x = torch.randn(1, N, C, device=dev) * 2.0 + 3.0
    w = 1.0 + 0.1 * torch.randn(C, device=dev)
    b = 0.1 * torch.randn(C, device=dev)
    emb = torch.randn(1, C, device=dev) if with_emb else None
    before = fused_groupnorm_silu.launches
    got = fused_groupnorm_silu(x, w, b, emb, groups=groups)
    torch.testing.assert_close(got, groupnorm_silu_plain(x, w, b, emb, groups=groups),
                               rtol=TOL_GN, atol=TOL_GN)
    assert fused_groupnorm_silu.launches == before + 1


# (B, N, C, groups): B=2 (clusters of 2), the alignment net's 2 channels a
# group (4-byte copies), 3 a group, and a group past a cluster's shared
# memory (the two-pass route)
@pytest.mark.parametrize("B,N,C,groups", [(2, 3328, 256, 32), (1, 1536, 64, 32),
                                          (1, 100, 96, 32), (1, 240000, 64, 32)])
def test_groupnorm_kernel_routes_match_plain_and_repeat(dev, B, N, C, groups):
    from prediff_torch.ops.groupnorm import gn_plan

    x = torch.randn(B, N, C, device=dev) * 2.0 + 3.0
    w = 1.0 + 0.1 * torch.randn(C, device=dev)
    b = 0.1 * torch.randn(C, device=dev)
    emb = torch.randn(B, C, device=dev)
    assert (gn_plan(B, N, C, groups) is None) == (N == 240000)
    got = fused_groupnorm_silu(x, w, b, emb, groups=groups)
    torch.testing.assert_close(got, groupnorm_silu_plain(x, w, b, emb, groups=groups),
                               rtol=TOL_GN, atol=TOL_GN)
    assert torch.equal(got, fused_groupnorm_silu(x, w, b, emb, groups=groups))


@pytest.mark.parametrize("M,C", [(3328, 256), (832, 512), (100, 128)])
def test_ffn_kernel_matches_plain(dev, M, C):
    hid = 4 * C
    args = (torch.randn(M, C, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(hid, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(hid, device=dev), torch.randn(C, hid, device=dev) / hid ** 0.5,
            0.1 * torch.randn(C, device=dev))
    _close_bf16(fused_ffn(*args), ffn_plain(*args, mxu_dtype=torch.bfloat16))


@pytest.mark.parametrize("shape", [(1, 13, 16, 16, 256), (1, 13, 8, 8, 512), (2, 5, 3, 7, 64)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_kernel_matches_plain(dev, shape, axis):
    heads = 4
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    args = (torch.randn(*shape, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(3 * C, C, device=dev) / C ** 0.5,
            0.5 * torch.randn(heads, vol, vol, device=dev), torch.randn(C, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(C, device=dev))
    scale = (C // heads) ** -0.5
    got = fused_axial_attention(args[0], axis, *args[1:], heads, scale)
    want = axial_attention_plain(args[0], axis, *args[1:], heads, scale, mxu_dtype=torch.bfloat16)
    _close_bf16(got, want)


def test_kernels_raise_on_what_they_do_not_take(dev):
    with pytest.raises(ValueError):
        fused_ffn(*(torch.randn(s, device=dev) for s in
                    [(8, 96), (96,), (96,), (384, 96), (384,), (96, 384), (96,)]))
    x = torch.randn(1, 8, 64, device=dev).transpose(1, 2)   # not contiguous
    with pytest.raises(ValueError):
        fused_groupnorm_silu(x, torch.ones(8, device=dev), torch.zeros(8, device=dev), groups=8)


# ---- input gradients, the whole resblock, autograd through every wrapper ----
# Gradients (ds, dh, dv, dh1) and the resblock (h1, h2, h3) chain more bf16
# roundings than the FFN and attention forwards, so they are held to a share
# of their own scale: max error <= 3e-2 and mean error <= 2e-3 of
# max |reference|.
REL_TOL_BWD = 3e-2
REL_MEAN_TOL_BWD = 2e-3


def _close_rel(got, want, tol=REL_TOL_BWD, mean_tol=REL_MEAN_TOL_BWD):
    scale = want.abs().max().item()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= tol * scale, (err.max().item(), scale)
    assert err.mean().item() <= mean_tol * scale, (err.mean().item(), scale)


def _ffn_args(dev, M, C):
    hid = 4 * C
    return (torch.randn(M, C, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(hid, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(hid, device=dev), torch.randn(C, hid, device=dev) / hid ** 0.5,
            0.1 * torch.randn(C, device=dev))


@pytest.mark.parametrize("M,C", [(1536, 128), (384, 256), (100, 128), (64, 512)])
def test_ffn_dx_kernel_matches_plain(dev, M, C):
    x, ln_w, ln_b, w1, b1, w2, _ = _ffn_args(dev, M, C)
    g = torch.randn(M, C, device=dev)
    before = fused_ffn_bwd_dx.launches
    got = fused_ffn_bwd_dx(x, g, ln_w, ln_b, w1, b1, w2)
    want = ffn_bwd_dx_plain(x, g, ln_w, ln_b, w1, b1, w2, mxu_dtype=torch.bfloat16)
    _close_rel(got, want)
    assert fused_ffn_bwd_dx.launches == before + 1


def _attn_args(dev, shape, axis, heads=4):
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    return (torch.randn(*shape, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(3 * C, C, device=dev) / C ** 0.5,
            0.5 * torch.randn(heads, vol, vol, device=dev), torch.randn(C, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(C, device=dev))


@pytest.mark.parametrize("shape", [(1, 6, 16, 16, 128), (1, 6, 8, 8, 256), (2, 5, 3, 7, 64)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_dx_kernel_matches_plain(dev, shape, axis):
    x, ln_w, ln_b, w_qkv, bias, w_proj, _ = _attn_args(dev, shape, axis)
    g = torch.randn(*shape, device=dev)
    scale = (shape[-1] // 4) ** -0.5
    got = fused_axial_attention_bwd_dx(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, scale)
    want = axial_attention_bwd_dx_plain(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, scale,
                                        mxu_dtype=torch.bfloat16)
    _close_rel(got, want)


def _resblock_args(dev, shape):
    B, T, H, W, C = shape
    k = lambda: torch.randn(C, C, 3, 3, 3, device=dev) / (27 * C) ** 0.5  # noqa: E731
    v = lambda s=0.1, m=0.0: m + s * torch.randn(C, device=dev)  # noqa: E731
    return (0.5 * torch.randn(*shape, device=dev), 0.3 * torch.randn(B, C, device=dev), k(), v(),
            k(), v(), v(m=1.0), v(), v(m=1.0), v())


# the alignment net's blocks at B = 1 and 2, a 64-channel one, and a group past
# 8 cluster ranks' shared memory (131072 tokens x 2 channels: the one-block
# GroupNorm kernels, ops/resblock.gn_tiles)
@pytest.mark.parametrize("shape", [(1, 6, 16, 16, 128), (1, 6, 8, 8, 256), (2, 3, 4, 5, 64),
                                   (2, 6, 16, 16, 128), (2, 6, 8, 8, 256), (1, 8, 128, 128, 64)])
def test_resblock_kernels_match_plain(dev, shape):
    args = _resblock_args(dev, shape)
    out, h2 = fused_resblock_fwd(*args)
    want_out, want_h2 = resblock_plain(*args, mxu_dtype=torch.bfloat16)
    assert h2.dtype == torch.bfloat16
    _close_rel(out, want_out)
    _close_rel(h2.float(), want_h2)
    x, emb, k1, _, k2, _, g1s, g1b, g2s, g2b = args
    g = torch.randn(*shape, device=dev)
    dx, demb = fused_resblock_bwd(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, g)
    want_dx, want_demb = resblock_bwd_plain(x, emb, k1, k2, g1s, g1b, g2s, g2b, h2.float(), g,
                                            mxu_dtype=torch.bfloat16)
    _close_rel(dx, want_dx)
    _close_rel(demb, want_demb)


# ---- all-gradients backwards (the training path) ----
FFN_GRADS = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
ATTN_GRADS = ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj")


@pytest.mark.parametrize("M,C", [(6656, 256), (1664, 512), (100, 128)])
def test_ffn_bwd_full_kernel_matches_plain(dev, M, C):
    x, ln_w, ln_b, w1, b1, w2, _ = _ffn_args(dev, M, C)
    g = torch.randn(M, C, device=dev)
    before = (fused_ffn_bwd_full.launches, fused_ffn_bwd_dx.launches)
    got = fused_ffn_bwd_full(x, g, ln_w, ln_b, w1, b1, w2)
    want = ffn_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, mxu_dtype=torch.bfloat16)
    for name, gt, wt in zip(FFN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    assert (fused_ffn_bwd_full.launches, fused_ffn_bwd_dx.launches) == (before[0] + 1, before[1])
    again = fused_ffn_bwd_full(x, g, ln_w, ln_b, w1, b1, w2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics: same bits


@pytest.mark.parametrize("shape", [(2, 13, 16, 16, 256), (2, 13, 8, 8, 512), (2, 5, 3, 7, 64)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_bwd_full_kernel_matches_plain(dev, shape, axis):
    x, ln_w, ln_b, w_qkv, bias, w_proj, _ = _attn_args(dev, shape, axis)
    g = torch.randn(*shape, device=dev)
    scale = (shape[-1] // 4) ** -0.5
    args = (x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, scale)
    got = fused_axial_attention_bwd_full(*args)
    want = axial_attention_bwd_full_plain(*args, mxu_dtype=torch.bfloat16)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    again = fused_axial_attention_bwd_full(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,N,C,groups", [(2, 3328, 256, 32), (2, 832, 512, 32), (2, 3328, 65, 65),
                                          (3, 50, 96, 32)])
@pytest.mark.parametrize("with_emb", [False, True])
def test_groupnorm_bwd_full_kernel_matches_plain(dev, B, N, C, groups, with_emb):
    x = torch.randn(B, N, C, device=dev) * 2.0 + 3.0
    g = torch.randn(B, N, C, device=dev)
    w = 1.0 + 0.1 * torch.randn(C, device=dev)
    b = 0.1 * torch.randn(C, device=dev)
    emb = torch.randn(B, C, device=dev) if with_emb else None
    got = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups=groups)
    want = groupnorm_silu_bwd_full_plain(x, g, w, b, emb, groups=groups)
    assert (got[3] is None) == (emb is None)
    for gt, wt in zip(got, want):
        if wt is not None:
            # all f32; only the order of the sums differs
            scale = wt.abs().max().item()
            assert (gt - wt).abs().max().item() <= TOL_GN * max(scale, 1.0)
    again = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups=groups)
    assert all(a is b or torch.equal(a, b) for a, b in zip(got, again))


# (B, N, C, groups) -> (cluster, vw) or the one-block route: the cluster
# kernel with 16-byte copies (the training micro-step's 256 and 512 wide, the
# alignment net's 128), with 4-byte copies (one channel a group, eight groups
# a block; two a group), the one-block-per-group kernel for 3 channels a group
# and for a group past a cluster's memory
GN_BWD_ROUTES = {(2, 3328, 256, 32): (2, 4), (2, 832, 512, 32): (2, 4), (2, 3328, 65, 65): (8, 1),
                 (1, 1536, 64, 32): (4, 1), (1, 1536, 128, 32): (4, 4), (3, 50, 96, 32): None,
                 (1, 160000, 64, 32): None}


@pytest.mark.parametrize("B,N,C,groups", list(GN_BWD_ROUTES))
def test_groupnorm_bwd_full_routes_match_plain_and_repeat(dev, B, N, C, groups):
    from prediff_torch.ops.groupnorm import gn_bwd_plan

    plan = gn_bwd_plan(B, N, C, groups)
    assert (None if plan is None else (plan.cluster, plan.vw)) == GN_BWD_ROUTES[(B, N, C, groups)]
    x = torch.randn(B, N, C, device=dev) * 2.0 + 3.0
    g = torch.randn(B, N, C, device=dev)
    w = 1.0 + 0.1 * torch.randn(C, device=dev)
    b = 0.1 * torch.randn(C, device=dev)
    emb = torch.randn(B, C, device=dev)
    before = fused_groupnorm_silu_bwd_full.launches
    got = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups=groups)
    assert fused_groupnorm_silu_bwd_full.launches == before + 1
    for gt, wt in zip(got, groupnorm_silu_bwd_full_plain(x, g, w, b, emb, groups=groups)):
        scale = wt.abs().max().item()
        assert (gt - wt).abs().max().item() <= TOL_GN * max(scale, 1.0)
    again = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups=groups)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _grads(fn, args, g):
    leaves = [a.clone().requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, g)


def test_autograd_through_every_wrapper_on_the_card(dev):
    """Each Function on CUDA gives the gradients of autograd of the f32 plain
    version, dx and every parameter gradient through the kernels (the
    resblock's parameter gradients through its plain version), so neither
    guidance nor training can skip a kernel."""
    cases = []
    x = torch.randn(1, 1536, 128, device=dev) * 2.0 + 1.0
    w, b, emb = 1.0 + 0.1 * torch.randn(128, device=dev), 0.1 * torch.randn(128, device=dev), \
        torch.randn(1, 128, device=dev)
    cases.append(("groupnorm", lambda *a: fused_groupnorm_silu(*a, groups=32),
                  lambda *a: groupnorm_silu_plain(*a, groups=32), (x, w, b, emb)))
    cases.append(("ffn", fused_ffn, ffn_plain, _ffn_args(dev, 384, 256)))
    a = _attn_args(dev, (1, 6, 8, 8, 256), 1)
    cases.append(("attention", lambda x, *p: fused_axial_attention(x, 1, *p, 4, 0.125),
                  lambda x, *p: axial_attention_plain(x, 1, *p, 4, 0.125), a))
    cases.append(("resblock", fused_resblock, lambda *p: resblock_plain(*p)[0],
                  _resblock_args(dev, (1, 6, 8, 8, 256))))
    full = (fused_groupnorm_silu_bwd_full, fused_ffn_bwd_full, fused_axial_attention_bwd_full)
    dx_only = (fused_ffn_bwd_dx, fused_axial_attention_bwd_dx)
    before = [f.launches for f in full + dx_only]
    for name, fused, plain, args in cases:
        g = torch.randn_like(args[0])
        got, want = _grads(fused, args, g), _grads(plain, args, g)
        for i, (gt, wt) in enumerate(zip(got, want)):
            assert gt is not None and torch.isfinite(gt).all(), (name, i)
            _close_rel(gt, wt)
    # asked for parameter gradients, each backward was its all-gradients kernel, once
    assert [f.launches for f in full + dx_only] == [b + 1 for b in before[:3]] + before[3:]


# ---- dropout inside the kernels (the v1 recipe's training path) ----
# The masks are a pure function of (seed, site, tensor, element), computed in
# integer arithmetic by the kernels and by the plain versions alike, so they
# are bit-identical and the tolerances above hold unchanged.
SEED, SITE = 0x1234_5678_9ABC_DEF0, 5


def test_keep_mask_on_the_card_equals_the_cpu(dev):
    for shape, rate in (((6656, 1024), 0.1), ((2, 13, 16, 16, 256), 0.1), ((7, 5), 0.5)):
        on_card = keep_mask(SEED, SITE, 1, shape, rate, dev)
        assert torch.equal(on_card.cpu(), keep_mask(SEED, SITE, 1, shape, rate, "cpu"))
        n = on_card.numel()
        assert abs(float(on_card.mean()) - (1 - rate)) <= 4 * (rate * (1 - rate) / n) ** 0.5


@pytest.mark.parametrize("M,C", [(6656, 256), (1664, 512), (100, 128)])
@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_ffn_dropout_kernels_match_plain(dev, M, C, rates):
    x, ln_w, ln_b, w1, b1, w2, b2 = _ffn_args(dev, M, C)
    g = torch.randn(M, C, device=dev)
    drop = (*rates, SEED, SITE)
    before = (fused_ffn_dropout.launches, fused_ffn_dropout_bwd_full.launches, fused_ffn.launches,
              fused_ffn_bwd_full.launches)
    out = fused_ffn_dropout(x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, *drop)
    _close_bf16(out, ffn_dropout_plain(x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, *drop,
                                       mxu_dtype=torch.bfloat16))
    got = fused_ffn_dropout_bwd_full(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop)
    want = ffn_dropout_bwd_full_plain(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop,
                                      mxu_dtype=torch.bfloat16)
    for name, gt, wt in zip(FFN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    assert (fused_ffn_dropout.launches, fused_ffn_dropout_bwd_full.launches, fused_ffn.launches,
            fused_ffn_bwd_full.launches) == (before[0] + 1, before[1] + 1, before[2], before[3])
    again = fused_ffn_dropout_bwd_full(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the dropped share of the output: where out == x the second mask dropped the FFN branch
    if rates[1] > 0:
        dropped = float((out == x).float().mean())
        assert abs(dropped - rates[1]) <= 4 * (rates[1] * (1 - rates[1]) / out.numel()) ** 0.5


@pytest.mark.parametrize("M,C", [(6656, 256), (1664, 512), (100, 128)])
def test_ffn_dropout_kernels_at_rate_0_give_the_bits_of_the_plain_kernels(dev, M, C):
    x, ln_w, ln_b, w1, b1, w2, b2 = _ffn_args(dev, M, C)
    g = torch.randn(M, C, device=dev)
    assert torch.equal(fused_ffn_dropout(x, ln_w, ln_b, w1, b1, w2, b2, 1e-5, 0.0, 0.0, SEED, SITE),
                       fused_ffn(x, ln_w, ln_b, w1, b1, w2, b2))
    got = fused_ffn_dropout_bwd_full(x, g, ln_w, ln_b, w1, b1, w2, 1e-5, 0.0, 0.0, SEED, SITE)
    want = fused_ffn_bwd_full(x, g, ln_w, ln_b, w1, b1, w2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("shape", [(2, 13, 16, 16, 256), (2, 13, 8, 8, 512), (2, 5, 3, 7, 64)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_dropout_kernels_match_plain(dev, shape, axis):
    x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj = _attn_args(dev, shape, axis)
    g = torch.randn(*shape, device=dev)
    scale = (shape[-1] // 4) ** -0.5
    drop = dict(rate_attn=0.1, rate_proj=0.1, seed=SEED, site=SITE)
    before = (fused_axial_attention_dropout.launches,
              fused_axial_attention_dropout_bwd_full.launches, fused_axial_attention.launches,
              fused_axial_attention_bwd_full.launches)
    out = fused_axial_attention_dropout(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4, scale,
                                        **drop)
    _close_bf16(out, axial_attention_plain(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4,
                                           scale, mxu_dtype=torch.bfloat16, **drop))
    args = (x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, scale)
    got = fused_axial_attention_dropout_bwd_full(*args, **drop)
    want = axial_attention_bwd_full_plain(*args, mxu_dtype=torch.bfloat16, **drop)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    after = (fused_axial_attention_dropout.launches,
             fused_axial_attention_dropout_bwd_full.launches, fused_axial_attention.launches,
             fused_axial_attention_bwd_full.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    again = fused_axial_attention_dropout_bwd_full(*args, **drop)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dropped = float((out == 0).float().mean())
    assert abs(dropped - 0.1) <= 4 * (0.09 / out.numel()) ** 0.5


@pytest.mark.parametrize("shape", [(2, 13, 16, 16, 256), (2, 13, 8, 8, 512)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_dropout_kernels_at_rate_0_give_the_bits_of_the_plain_kernels(dev, shape, axis):
    x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj = _attn_args(dev, shape, axis)
    g = torch.randn(*shape, device=dev)
    scale = (shape[-1] // 4) ** -0.5
    assert torch.equal(
        fused_axial_attention_dropout(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4, scale,
                                      seed=SEED, site=SITE),
        fused_axial_attention(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4, scale))
    args = (x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, scale)
    got = fused_axial_attention_dropout_bwd_full(*args, seed=SEED, site=SITE)
    assert all(torch.equal(a, b) for a, b in zip(got, fused_axial_attention_bwd_full(*args)))


def test_autograd_through_the_dropout_wrappers_on_the_card(dev):
    """With a seed each Function runs its dropout kernels, forward and
    backward once, and gives the gradients of autograd of the f32 plain
    version under the same masks."""
    f = _ffn_args(dev, 384, 256)
    a = _attn_args(dev, (1, 6, 8, 8, 256), 1)
    cases = [
        ("ffn", lambda *p: fused_ffn(*p, 1e-5, 0.1, 0.1, SEED, SITE),
         lambda *p: ffn_dropout_plain(*p, 1e-5, 0.1, 0.1, SEED, SITE), f),
        ("attention",
         lambda x, *p: fused_axial_attention(x, 1, *p, 4, 0.125, 1e-5, 0.1, 0.1, SEED, SITE),
         lambda x, *p: axial_attention_plain(x, 1, *p, 4, 0.125, rate_attn=0.1, rate_proj=0.1,
                                             seed=SEED, site=SITE), a)]
    counted = (fused_ffn_dropout, fused_ffn_dropout_bwd_full, fused_axial_attention_dropout,
               fused_axial_attention_dropout_bwd_full)
    before = [fn.launches for fn in counted]
    for name, fused, plain, args in cases:
        g = torch.randn_like(args[0])
        for i, (gt, wt) in enumerate(zip(_grads(fused, args, g), _grads(plain, args, g))):
            assert gt is not None and torch.isfinite(gt).all(), (name, i)
            _close_rel(gt, wt)
    assert [fn.launches for fn in counted] == [b + 1 for b in before]


# a rank past the first draws its rows of the global batch's masks from an element base
# (ops/dropout.py); one base past 2**32 (the Philox counter's high word)
BASES = (2 ** 32 + 4 * 1234, 4 * 5678)


def test_dropout_kernels_at_an_element_base_match_plain(dev):
    """Each dropout kernel, forward and all-gradients backward, at nonzero
    element bases against its plain version at the same bases (the masks
    moved from base 0's); a base that is not a multiple of 4 raises."""
    drop = dict(seed=SEED, site=SITE, bases=BASES)
    f = _ffn_args(dev, 1664, 512)
    g = torch.randn(1664, 512, device=dev)
    out = fused_ffn_dropout(*f, 1e-5, 0.1, 0.1, **drop)
    _close_bf16(out, ffn_dropout_plain(*f, 1e-5, 0.1, 0.1, mxu_dtype=torch.bfloat16, **drop))
    assert not torch.equal(out, fused_ffn_dropout(*f, 1e-5, 0.1, 0.1, SEED, SITE))
    got = fused_ffn_dropout_bwd_full(f[0], g, *f[1:6], 1e-5, 0.1, 0.1, **drop)
    want = ffn_dropout_bwd_full_plain(f[0], g, *f[1:6], 1e-5, 0.1, 0.1,
                                      mxu_dtype=torch.bfloat16, **drop)
    for gt, wt in zip(got, want):
        _close_rel(gt, wt)
    with pytest.raises(ValueError, match="multiples of 4"):
        fused_ffn_dropout(*f, 1e-5, 0.1, 0.1, SEED, SITE, (6, 8))

    shape, axis = (2, 13, 8, 8, 512), 1
    a = _attn_args(dev, shape, axis)
    g = torch.randn(*shape, device=dev)
    adrop = dict(rate_attn=0.1, rate_proj=0.1, **drop)
    out = fused_axial_attention_dropout(a[0], axis, *a[1:], 4, 0.125, 1e-5, **adrop)
    _close_bf16(out, axial_attention_plain(a[0], axis, *a[1:], 4, 0.125, 1e-5,
                                           mxu_dtype=torch.bfloat16, **adrop))
    args = (a[0], g, axis, *a[1:6], 4, 0.125)
    got = fused_axial_attention_dropout_bwd_full(*args, **adrop)
    want = axial_attention_bwd_full_plain(*args, mxu_dtype=torch.bfloat16, **adrop)
    for gt, wt in zip(got, want):
        _close_rel(gt, wt)

    c = _cuboid_args(dev, (2, 52, 64, 256))
    g = torch.randn(2, 52, 64, 256, device=dev)
    out = fused_cuboid_attention_layer_dropout(*c, 4, 0.125, 1e-5, **adrop)
    _close_bf16(out, cuboid_attention_dropout_plain(*c, 4, 0.125, 1e-5,
                                                    mxu_dtype=torch.bfloat16, **adrop))
    args = (c[0], g, *c[1:6], 4, 0.125)
    got = fused_cuboid_attention_layer_dropout_bwd_full(*args, **adrop)
    want = cuboid_attention_dropout_bwd_full_plain(*args, mxu_dtype=torch.bfloat16, **adrop)
    for gt, wt in zip(got, want):
        _close_rel(gt, wt)


# ---- the general cuboid layer and the grouped masked core ----
# (B, cuboids, vol, C): the video_swin_1x8 UNet (13x16x16x256, 13x8x8x512) and
# alignment net (6x16x16x128) shapes, and vol 128 and 256 (query tiles of 32
# and 16 rows), vol 36 (a ragged tile)
CUBOID_SHAPES = [(1, 52, 64, 256), (1, 13, 64, 512), (1, 24, 64, 128), (1, 26, 128, 256),
                 (1, 13, 256, 256), (2, 5, 36, 64)]


def _cuboid_args(dev, shape, heads=4):
    B, nC, vol, C = shape
    return (torch.randn(*shape, device=dev), 1.0 + 0.1 * torch.randn(C, device=dev),
            0.1 * torch.randn(C, device=dev), torch.randn(3 * C, C, device=dev) / C ** 0.5,
            0.5 * torch.randn(heads, vol, vol, device=dev), torch.randn(C, C, device=dev) / C ** 0.5,
            0.1 * torch.randn(C, device=dev))


@pytest.mark.parametrize("shape", CUBOID_SHAPES)
def test_cuboid_layer_kernels_match_plain(dev, shape):
    heads = 4
    args = _cuboid_args(dev, shape, heads)
    scale = (shape[3] // heads) ** -0.5
    before = (fused_cuboid_attention_layer.launches, fused_cuboid_attention_layer_bwd_dx.launches)
    _close_bf16(fused_cuboid_attention_layer(*args, heads, scale),
                cuboid_attention_plain(*args, heads, scale, mxu_dtype=torch.bfloat16))
    g = torch.randn_like(args[0])
    _close_rel(fused_cuboid_attention_layer_bwd_dx(args[0], g, *args[1:6], heads, scale),
               cuboid_attention_bwd_dx_plain(args[0], g, *args[1:6], heads, scale,
                                             mxu_dtype=torch.bfloat16))
    assert (fused_cuboid_attention_layer.launches,
            fused_cuboid_attention_layer_bwd_dx.launches) == (before[0] + 1, before[1] + 1)


# (B, cuboids, vol, C), heads: past the QKV product's LN tile (bf16 LN rows),
# 12 head channels (the core's element-wise copies, hc padded to 16), ragged
# vol in three key tiles
@pytest.mark.parametrize("shape,heads", [((1, 4, 64, 1024), 4), ((1, 3, 40, 192), 16),
                                         ((2, 5, 150, 128), 4)])
def test_cuboid_layer_forward_routes_match_plain(dev, shape, heads):
    args = _cuboid_args(dev, shape, heads)
    scale = (shape[3] // heads) ** -0.5
    got = fused_cuboid_attention_layer(*args, heads, scale)
    err = (got - cuboid_attention_plain(*args, heads, scale, mxu_dtype=torch.bfloat16)).abs()
    # the products sum C terms: a flipped bf16 rounding of q, k or v grows as
    # sqrt(C), so the mean bar is MEAN_TOL_BF16's at C = 512 and above, as sqrt(C / 512)
    assert err.max().item() <= TOL_BF16, err.max().item()
    assert err.mean().item() <= MEAN_TOL_BF16 * max(1.0, shape[3] / 512) ** 0.5, err.mean().item()


# (B, heads, cuboids, vol, hc), and the window mask's (T, H, W), cuboid, shift,
# padding type: the UNet's shifted 1x8x8 windows (vol 64), video_swin_2x8's
# padded 2x8x8 cuboids unmasked (vol 128), "ignore" padding with fully masked
# rows, a 1x32x40 window (vol 1280), "full" on the UNet (vol 3328), and head
# widths the kernel pads (12: not a multiple of 8; 200: four 64-channel
# chunks, the last one partial)
GROUPED_CASES = [
    ((1, 4, 52, 64, 64), ((13, 16, 16), (1, 8, 8), (0, 4, 4), "zeros")),
    ((1, 4, 28, 128, 64), None),
    ((2, 2, 12, 32, 32), ((5, 6, 6), (2, 4, 4), (0, 0, 0), "ignore")),
    ((1, 4, 2, 1280, 32), None),
    ((1, 4, 1, 3328, 64), None),
    ((1, 2, 3, 20, 12), None),
    ((1, 2, 3, 70, 200), None),
]


@pytest.mark.parametrize("shape,window", GROUPED_CASES)
def test_grouped_kernel_matches_plain(dev, shape, window):
    B, heads, nC, vol, hc = shape
    q, k, v = (torch.randn(*shape, device=dev) for _ in range(3))
    bias = 0.5 * torch.randn(heads, vol, vol, device=dev)
    mask = None
    if window is not None:
        mask = torch.from_numpy(compute_cuboid_self_attention_mask(
            window[0], window[1], window[2], ("l", "l", "l"), window[3])).to(dev)
        assert tuple(mask.shape) == (nC, vol, vol)
    before = fused_cuboid_attention_grouped.launches
    got = fused_cuboid_attention_grouped(q, k, v, bias, mask, hc ** -0.5)
    want = grouped_attention_plain(q, k, v, bias, mask, hc ** -0.5)
    assert fused_cuboid_attention_grouped.launches == before + 1
    # the kernel's 3xTF32 products against f32; another sum order and the
    # online softmax
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    if mask is not None and (~mask.any(-1)).any():
        assert (got[:, :, ~mask.any(-1)] == 0).all()


def test_grouped_kernel_refuses_rows_it_cannot_copy_in_16_bytes(dev):
    q = torch.randn(1, 2, 3, 20, 6, device=dev)
    bias = torch.randn(2, 20, 20, device=dev)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_cuboid_attention_grouped(q, q, q, bias, None, 0.5)


def test_autograd_through_the_cuboid_wrappers_on_the_card(dev):
    """Training: dx and every parameter gradient of the layer from its
    all-gradients kernel, once; guidance: dx alone from the dx kernel; q, k,
    v and bias through the grouped core from autograd of its plain version."""
    args = _cuboid_args(dev, (1, 6, 64, 128))
    g = torch.randn_like(args[0])
    counted = (fused_cuboid_attention_layer_bwd_full, fused_cuboid_attention_layer_bwd_dx)
    before = [fn.launches for fn in counted]
    got = _grads(lambda *a: fused_cuboid_attention_layer(*a, 4, 0.17), args, g)
    want = _grads(lambda *a: cuboid_attention_plain(*a, 4, 0.17), args, g)
    for gt, wt in zip(got, want):
        _close_rel(gt, wt)
    assert [fn.launches for fn in counted] == [before[0] + 1, before[1]]
    x = args[0].clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(fused_cuboid_attention_layer(x, *args[1:], 4, 0.17), [x], g)
    _close_rel(dx, want[0])
    assert [fn.launches for fn in counted] == [before[0] + 1, before[1] + 1]
    q, k, v = (torch.randn(1, 2, 3, 64, 32, device=dev) for _ in range(3))
    bias = torch.randn(2, 64, 64, device=dev)
    mask = torch.rand(3, 64, 64, device=dev) > 0.3
    gq = torch.randn_like(q)
    got = _grads(lambda *a: fused_cuboid_attention_grouped(*a, mask, 0.2), (q, k, v, bias), gq)
    want = _grads(lambda *a: grouped_attention_plain(*a, mask, 0.2), (q, k, v, bias), gq)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, rtol=1e-4, atol=1e-4)


# ---- training the general layer: all gradients, and dropout inside the kernels ----
@pytest.mark.parametrize("shape", CUBOID_SHAPES + [(2, 52, 64, 256), (2, 13, 64, 512)])
def test_cuboid_bwd_full_kernel_matches_plain(dev, shape):
    heads = 4
    args = _cuboid_args(dev, shape, heads)[:6]
    g = torch.randn_like(args[0])
    scale = (shape[3] // heads) ** -0.5
    before = fused_cuboid_attention_layer_bwd_full.launches
    got = fused_cuboid_attention_layer_bwd_full(args[0], g, *args[1:], heads, scale)
    want = cuboid_attention_bwd_full_plain(args[0], g, *args[1:], heads, scale,
                                           mxu_dtype=torch.bfloat16)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    assert fused_cuboid_attention_layer_bwd_full.launches == before + 1
    again = fused_cuboid_attention_layer_bwd_full(args[0], g, *args[1:], heads, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics: same bits


@pytest.mark.parametrize("shape", [(2, 52, 64, 256), (2, 13, 64, 512), (1, 13, 256, 256),
                                   (2, 5, 36, 64)])
def test_cuboid_dropout_kernels_match_plain(dev, shape):
    heads = 4
    args = _cuboid_args(dev, shape, heads)
    g = torch.randn_like(args[0])
    scale = (shape[3] // heads) ** -0.5
    drop = dict(rate_attn=0.1, rate_proj=0.1, seed=SEED, site=SITE)
    counted = (fused_cuboid_attention_layer_dropout, fused_cuboid_attention_layer_dropout_bwd_full,
               fused_cuboid_attention_layer, fused_cuboid_attention_layer_bwd_full)
    before = [fn.launches for fn in counted]
    out = fused_cuboid_attention_layer_dropout(*args, heads, scale, **drop)
    _close_bf16(out, cuboid_attention_dropout_plain(*args, heads, scale,
                                                    mxu_dtype=torch.bfloat16, **drop))
    bargs = (args[0], g, *args[1:6], heads, scale)
    got = fused_cuboid_attention_layer_dropout_bwd_full(*bargs, **drop)
    want = cuboid_attention_dropout_bwd_full_plain(*bargs, mxu_dtype=torch.bfloat16, **drop)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    assert [fn.launches for fn in counted] == [before[0] + 1, before[1] + 1] + before[2:]
    again = fused_cuboid_attention_layer_dropout_bwd_full(*bargs, **drop)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dropped = float((out == 0).float().mean())
    assert abs(dropped - 0.1) <= 4 * (0.09 / out.numel()) ** 0.5


@pytest.mark.parametrize("shape", [(2, 52, 64, 256), (1, 13, 256, 256)])
def test_cuboid_dropout_kernels_at_rate_0_give_the_bits_of_the_plain_kernels(dev, shape):
    args = _cuboid_args(dev, shape)
    g = torch.randn_like(args[0])
    scale = (shape[3] // 4) ** -0.5
    assert torch.equal(fused_cuboid_attention_layer_dropout(*args, 4, scale, seed=SEED, site=SITE),
                       fused_cuboid_attention_layer(*args, 4, scale))
    bargs = (args[0], g, *args[1:6], 4, scale)
    got = fused_cuboid_attention_layer_dropout_bwd_full(*bargs, seed=SEED, site=SITE)
    assert all(torch.equal(a, b)
               for a, b in zip(got, fused_cuboid_attention_layer_bwd_full(*bargs)))


def test_autograd_through_the_cuboid_dropout_wrapper_on_the_card(dev):
    """With a seed the layer's Function runs its dropout kernels, forward and
    backward once, and gives the gradients of autograd of the f32 plain
    version under the same masks."""
    args = _cuboid_args(dev, (2, 6, 64, 128))
    g = torch.randn_like(args[0])
    kw = dict(rate_attn=0.1, rate_proj=0.2, seed=SEED, site=SITE)
    counted = (fused_cuboid_attention_layer_dropout, fused_cuboid_attention_layer_dropout_bwd_full)
    before = [fn.launches for fn in counted]
    got = _grads(lambda *a: fused_cuboid_attention_layer(*a, 4, 0.17, 1e-5, **kw), args, g)
    want = _grads(lambda *a: cuboid_attention_plain(*a, 4, 0.17, **kw), args, g)
    for gt, wt in zip(got, want):
        assert torch.isfinite(gt).all()
        _close_rel(gt, wt)
    assert [fn.launches for fn in counted] == [b + 1 for b in before]


# ---- the bf16 3x3x3 conv (use_pallas_conv) and the round-1 cuboid ops ----
# The conv: x and the weights rounded to bf16 from the same f32 values on both
# sides, f32 sums in another order: 1e-3 of the output's max covers it.
TOL_CONV = 1e-3


def _conv_close(got, want):
    err = (got - want).abs().max().item()
    assert err <= TOL_CONV * want.abs().max().item(), err


CONV_SHAPES = [(1, 13, 16, 16, 256, 256), (1, 13, 8, 8, 512, 512), (2, 13, 8, 8, 512, 512),
               (1, 6, 16, 16, 128, 128), (1, 5, 8, 8, 128, 256), (2, 13, 16, 16, 256, 256)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernels_match_plain(dev, shape):
    B, T, H, W, C, OC = shape
    x = torch.randn(B, T, H, W, C, device=dev)
    w = torch.randn(OC, C, 3, 3, 3, device=dev) / (27 * C) ** 0.5
    b = 0.1 * torch.randn(OC, device=dev)
    g = torch.randn(B, T, H, W, OC, device=dev)
    before = (conv3x3x3_forward.launches, conv3x3x3_dx.launches)
    _conv_close(conv3x3x3_forward(x, w, b), conv3x3x3_plain(x, w, b))
    _conv_close(conv3x3x3_dx(g, w), conv3x3x3_dx_plain(g, w))
    assert (conv3x3x3_forward.launches, conv3x3x3_dx.launches) == (before[0] + 1, before[1] + 1)


def test_autograd_through_the_conv_wrapper_on_the_card(dev):
    """dx from the kernel, dw (f32 from the unrounded x) and db from autograd,
    against the plain route's gradients."""
    x = torch.randn(1, 6, 16, 16, 128, device=dev, requires_grad=True)
    w = (torch.randn(128, 128, 3, 3, 3, device=dev) / (27 * 128) ** 0.5).requires_grad_(True)
    b = (0.1 * torch.randn(128, device=dev)).requires_grad_(True)
    g = torch.randn(1, 6, 16, 16, 128, device=dev)
    got = torch.autograd.grad(fused_conv3x3x3(x, w, b), (x, w, b), g)
    dx = conv3x3x3_dx_plain(g, w.detach())
    dw = torch.nn.grad.conv3d_weight(x.detach().permute(0, 4, 1, 2, 3), w.shape,
                                     g.permute(0, 4, 1, 2, 3), padding=1)
    _conv_close(got[0], dx)
    _conv_close(got[1], dw)
    _conv_close(got[2], g.sum(dim=(0, 1, 2, 3)))


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_kernel_repeats_bit_for_bit(dev, shape):
    """Two launches give the same bits, with and without a cluster split
    (the partials are added in rank order, no atomics)."""
    B, T, H, W, C, OC = shape
    x = torch.randn(B, T, H, W, C, device=dev)
    w = torch.randn(OC, C, 3, 3, 3, device=dev) / (27 * C) ** 0.5
    b = 0.1 * torch.randn(OC, device=dev)
    g = torch.randn(B, T, H, W, OC, device=dev)
    assert torch.equal(conv3x3x3_forward(x, w, b), conv3x3x3_forward(x, w, b))
    assert torch.equal(conv3x3x3_dx(g, w), conv3x3x3_dx(g, w))


def test_resblock_conv_is_the_shared_conv(dev):
    """The resblock's second conv against the plain conv: with GN2's gamma at
    0 the conv sees h3 = bf16(silu(beta2)) per channel, and the resblock's
    output is that conv plus x.  Both run the kernel of csrc/conv_wgmma.cuh
    on the same tiles, so the resblock's output is the standalone conv's
    plus x bit for bit."""
    shape = (1, 6, 8, 8, 256)
    x, emb, k1, b1, k2, b2, g1s, g1b, _, g2b = _resblock_args(dev, shape)
    out, _ = fused_resblock_fwd(x, emb, k1, b1, k2, b2, g1s, g1b, torch.zeros_like(g2b), g2b)
    h3 = (g2b / (1 + torch.exp(-g2b))).to(torch.bfloat16).float().expand(shape).contiguous()
    _conv_close(out, conv3x3x3_plain(h3, k2, b2) + x)
    assert torch.equal(out, conv3x3x3_forward(h3, k2, b2) + x)


def test_resblock_weights_are_laid_out_once_per_version(dev):
    """The resblock reads its convs' bf16 layouts from the per-version cache:
    the same layouts on a second call, two calls bit-equal; an in-place
    update makes new ones, and the block follows it (against the plain
    version), as under a frozen model's requires_grad_(False)."""
    shape = (1, 6, 8, 8, 256)
    args = _resblock_args(dev, shape)
    k1 = args[2]
    out, h2 = fused_resblock_fwd(*args)
    first = (weight_layout(k1), weight_layout(k1, dx=True))
    g = torch.randn(*shape, device=dev)
    bargs = (args[0], args[1], args[2], args[4], *args[6:], h2, g)
    dx, demb = fused_resblock_bwd(*bargs)
    again, _ = fused_resblock_fwd(*args)
    assert torch.equal(out, again)
    assert torch.equal(dx, fused_resblock_bwd(*bargs)[0])
    assert weight_layout(k1) is first[0] and weight_layout(k1, dx=True) is first[1]
    with torch.no_grad():
        k1.mul_(0.5)
    k1.requires_grad_(False)
    out, h2 = fused_resblock_fwd(*args)
    assert weight_layout(k1) is not first[0]
    _close_rel(out, resblock_plain(*args, mxu_dtype=torch.bfloat16)[0])


# (B, cuboids, vol, C), heads: each route of the general layer's backward --
# fused at C = 1024 (hc 256) and at 12 head channels in a ragged 40-row
# cuboid, 3 head channels (odd: element-wise stores), the split pair at vol
# 150 (three key tiles), at hc 512 in a 64-row cuboid (the fused core's
# tiles do not fit), and at vol 17
CUBOID_BWD_ROUTES = [((1, 4, 64, 1024), 4), ((1, 3, 40, 192), 16), ((2, 3, 24, 192), 64),
                     ((2, 5, 150, 128), 4), ((1, 2, 64, 2048), 4), ((3, 2, 17, 64), 2)]


@pytest.mark.parametrize("shape,heads", CUBOID_BWD_ROUTES)
def test_cuboid_bwd_routes_match_plain(dev, shape, heads):
    args = _cuboid_args(dev, shape, heads)
    g = torch.randn_like(args[0])
    scale = (shape[3] // heads) ** -0.5
    bargs = (args[0], g, *args[1:6], heads, scale)
    _close_rel(fused_cuboid_attention_layer_bwd_dx(*bargs),
               cuboid_attention_bwd_dx_plain(*bargs, mxu_dtype=torch.bfloat16))
    got = fused_cuboid_attention_layer_bwd_full(*bargs)
    want = cuboid_attention_bwd_full_plain(*bargs, mxu_dtype=torch.bfloat16)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        assert gt.shape == wt.shape, name
        _close_rel(gt, wt)
    assert all(torch.equal(a, b) for a, b in zip(got, fused_cuboid_attention_layer_bwd_full(*bargs)))
    drop = dict(rate_attn=0.1, rate_proj=0.1, seed=SEED, site=SITE)
    got = fused_cuboid_attention_layer_dropout_bwd_full(*bargs, **drop)
    want = cuboid_attention_dropout_bwd_full_plain(*bargs, mxu_dtype=torch.bfloat16, **drop)
    for name, gt, wt in zip(ATTN_GRADS, got, want):
        _close_rel(gt, wt)
    zero = fused_cuboid_attention_layer_dropout_bwd_full(*bargs, seed=SEED, site=SITE)
    assert all(torch.equal(a, b) for a, b in zip(zero, fused_cuboid_attention_layer_bwd_full(*bargs)))


CORE_CASES = [((1, 52, 4, 64, 64), ((13, 16, 16), (1, 8, 8), (0, 4, 4), "zeros")),
              ((1, 52, 4, 64, 64), None), ((2, 16, 4, 13, 64), None),
              ((2, 12, 2, 32, 32), ((5, 6, 6), (2, 4, 4), (0, 0, 0), "ignore"))]


@pytest.mark.parametrize("shape,window", CORE_CASES)
def test_cuboid_core_kernel_matches_plain(dev, shape, window):
    """The round-1 core on the cuboid-major layout; 3xTF32 against f32."""
    B, nC, heads, vol, hc = shape
    q, k, v = (torch.randn(*shape, device=dev) for _ in range(3))
    bias = 0.5 * torch.randn(heads, vol, vol, device=dev)
    mask = None
    if window is not None:
        mask = torch.from_numpy(compute_cuboid_self_attention_mask(
            window[0], window[1], window[2], ("l", "l", "l"), window[3])).to(dev)
    before = fused_cuboid_attention.launches
    got = fused_cuboid_attention(q, k, v, bias, mask, hc ** -0.5)
    want = cuboid_attention_plain_core(q, k, v, bias, mask, hc ** -0.5)
    assert fused_cuboid_attention.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    if mask is not None and (~mask.any(-1)).any():   # (cuboid, row) fully masked: 0 on every head
        assert (got.transpose(1, 2)[:, :, ~mask.any(-1)] == 0).all()
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_cuboid_attention(q.requires_grad_(True), k, v, bias, mask, hc ** -0.5)


V3_SHAPES = [(1, 52, 64, 256), (2, 13, 16, 64), (1, 8, 16, 32)]


@pytest.mark.parametrize("shape", V3_SHAPES)
def test_cuboid_layer_v3_kernel_matches_plain(dev, shape):
    """The round-1 whole layer: the LN + QKV and projection products and the
    core in 3xTF32 on the tensor cores, against f32."""
    B, nC, vol, C = shape
    heads = 4 if C > 32 else 2
    x = torch.randn(*shape, device=dev)
    ln_w, ln_b = 1.0 + 0.1 * torch.randn(C, device=dev), 0.1 * torch.randn(C, device=dev)
    w_qkv = torch.randn(3 * C, C, device=dev) / C ** 0.5
    bias = 0.5 * torch.randn(heads, vol, vol, device=dev)
    w_proj, b_proj = torch.randn(C, C, device=dev) / C ** 0.5, 0.1 * torch.randn(C, device=dev)
    args = (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, (C // heads) ** -0.5)
    before = fused_cuboid_attention_layer_v3.launches
    got = fused_cuboid_attention_layer_v3(*args)
    want = cuboid_attention_layer_v3_plain(*args)
    assert fused_cuboid_attention_layer_v3.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# ---- the reverse chain as captured CUDA graphs (diffusion/graphs.py) ------ #
def _graph_predictor(dev):
    """configs/tiny_smoke.yaml at base_units 128 (widths 128 and 256, which
    the FFN, attention and resblock kernels take), randomized weights (the
    v1 init leaves the FFN's and attention's output products at 0), guided.
    Building it switches cuDNN to its deterministic algorithms
    (``resolve_device``): at these shapes the default input-gradient
    convolutions of the guidance step add with atomics, and the eager chain
    would not repeat."""
    import os

    from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    tiny = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                        "tiny_smoke.yaml")
    cfg = load_config(prediff_default_config, tiny)
    cfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"base_units": 128}, "align": {"model_args": {"base_units": 128}}}}))
    gen = torch.Generator().manual_seed(0)
    params = {key: init_params_(build(cfg), gen, randomize=True).state_dict()
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    return PreDiffPredictor(cfg, params=params, with_alignment=True, device=dev)


def _counts():
    from prediff_torch.diffusion.graphs import launch_counters

    return {fn.__name__: fn.launches for fn in launch_counters()}


@pytest.mark.parametrize("kw", [
    dict(timesteps=4, use_alignment=True, guidance_every_k=2),
    dict(timesteps=6, ddim_steps=3, use_alignment=True, ddim_eta=0.5),
    dict(timesteps=3, return_intermediates=True, return_decoded=False)])
def test_graph_chain_gives_the_bits_of_the_eager_chain(dev, kw):
    """Temperature 1, the same seed: the chain that captures, the chain that
    only replays and the eager chain agree bit for bit, with the same
    launch counts (each replay adds its graph's launches)."""
    predictor = _graph_predictor(dev)
    ld = predictor.ld
    y = torch.rand((2, 3, 32, 32, 1), generator=torch.Generator().manual_seed(1)).to(dev)
    args = dict(kw, sampler="ddim" if "ddim_steps" in kw else "ddpm")
    if args.pop("use_alignment", False):
        args.update(use_alignment=True, alignment_kwargs={"avg_x_gt": torch.tensor([[0.3], [0.6]])})
    x0 = torch.randn((2,) + ld.latent_shape, generator=torch.Generator().manual_seed(3)).to(dev)
    mask = (torch.rand((1,) + ld.latent_shape, generator=torch.Generator().manual_seed(4)) > 0.5)
    if args.get("return_intermediates"):
        ld.log_every_t = 1                           # three segments
        args.update(mask=mask.float().to(dev), x0=x0)
    outs, counts = [], []
    for plain in (False, False, True):
        before = _counts()
        gen = torch.Generator(dev).manual_seed(7)
        if plain:
            with ld._plain_chain():
                out = ld.sample(y, generator=gen, **args)
        else:
            out = ld.sample(y, generator=gen, **args)
        torch.cuda.synchronize()
        counts.append({k: v - before[k] for k, v in _counts().items()})
        outs.append(out)
    assert len(ld.graphs) == 1 and ld.graphs.captures == len(ld.graphs.entries()[0].graphs)
    flat = [torch.cat([o[0].flatten()] + [i.flatten() for i in o[1]])
            if isinstance(o, tuple) else o for o in outs]
    assert torch.isfinite(flat[0]).all()
    assert torch.equal(flat[0], flat[2]) and torch.equal(flat[1], flat[2])
    assert counts[0] == counts[1] == counts[2] and sum(counts[2].values()) > 0


def test_a_parameter_update_recaptures(dev):
    """An in-place update between two forecasts drops the graphs; the second
    forecast is captured anew and equals the eager chain on the new weights."""
    predictor = _graph_predictor(dev)
    y = torch.rand((1, 3, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    kw = dict(timesteps=3, use_alignment=True, avg_x_gt=[[0.4]])
    first = predictor.predict(y, generator=torch.Generator(dev).manual_seed(5), **kw)
    captures = predictor.ld.graphs.captures
    w = next(p for n, p in predictor.ld.unet.named_parameters() if "ffn" in n and p.ndim == 2)
    with torch.no_grad():
        w.mul_(1.5)
    second = predictor.predict(y, generator=torch.Generator(dev).manual_seed(5), **kw)
    assert predictor.ld.graphs.captures == 2 * captures
    with predictor.ld._plain_chain():
        eager = predictor.predict(y, generator=torch.Generator(dev).manual_seed(5), **kw)
    assert torch.equal(second, eager) and not torch.equal(first, second)


# --------------------------------------------------------------------------- #
# The bf16 forms (guidance on the alignment net's bf16 copy): each kernel on
# bf16 inputs and parameters against its plain version on the same ones (which
# widens them and rounds its result to bf16), at the f32 form's bar plus one
# bf16 ulp of the output's max; the output bf16, the launch counted as a bf16
# form.  At the alignment net's guidance shapes.
BF16 = torch.bfloat16


def _bf16_close(got, want, rel_tol):
    assert got.dtype == BF16
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (torch.floor(torch.log2(torch.tensor(scale))).item() - 7)
    err = (got.float() - want.float()).abs()
    assert float(err.max()) <= rel_tol * scale + ulp


def _r(dev, *shape, scale=1.0, shift=0.0):
    return (torch.randn(shape, device=dev) * scale + shift).to(BF16)


@pytest.mark.parametrize("C", [64, 128])
def test_groupnorm_bf16_forms_match_plain(dev, C):
    x, w, b, g = _r(dev, 1, 1536, C, scale=2.0, shift=1.0), _r(dev, C, shift=1.0), _r(dev, C), \
        _r(dev, 1, 1536, C)
    n0, b0 = fused_groupnorm_silu.bf16_launches, fused_groupnorm_silu_bwd_full.bf16_launches
    _bf16_close(fused_groupnorm_silu(x, w, b, None, 32), groupnorm_silu_plain(x, w, b, None, 32),
                TOL_GN)
    got = fused_groupnorm_silu_bwd_full(x, g, w, b, None, 32)
    want = groupnorm_silu_bwd_full_plain(x, g, w, b, None, 32)
    _bf16_close(got[0], want[0], TOL_GN)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4 * float(want[1].abs().max()))
    assert fused_groupnorm_silu.bf16_launches == n0 + 1
    assert fused_groupnorm_silu_bwd_full.bf16_launches == b0 + 1


@pytest.mark.parametrize("M,C", [(1536, 128), (384, 256)])
def test_ffn_bf16_forms_match_plain(dev, M, C):
    hid = 4 * C
    x, g = _r(dev, M, C), _r(dev, M, C)
    p = (_r(dev, C, shift=1.0, scale=0.1), _r(dev, C, scale=0.1), _r(dev, hid, C, scale=C ** -0.5),
         _r(dev, hid, scale=0.1), _r(dev, C, hid, scale=hid ** -0.5), _r(dev, C, scale=0.1))
    _bf16_close(fused_ffn(x, *p), ffn_plain(x, *p, mxu_dtype=BF16), TOL_BF16)
    _bf16_close(fused_ffn_bwd_dx(x, g, *p[:5]), ffn_bwd_dx_plain(x, g, *p[:5], mxu_dtype=BF16),
                3e-2)


@pytest.mark.parametrize("shape", [(1, 6, 16, 16, 128), (1, 6, 8, 8, 256)])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axial_attention_bf16_forms_match_plain(dev, shape, axis):
    C, vol, heads = shape[-1], shape[1 + axis], 4
    x, g = _r(dev, *shape), _r(dev, *shape)
    ln_w, ln_b = _r(dev, C, shift=1.0, scale=0.1), _r(dev, C, scale=0.1)
    w_qkv, w_proj = _r(dev, 3 * C, C, scale=C ** -0.5), _r(dev, C, C, scale=C ** -0.5)
    bias, b_proj = torch.randn(heads, vol, vol, device=dev) * 0.5, _r(dev, C, scale=0.1)
    scale = (C // heads) ** -0.5
    args = (ln_w, ln_b, w_qkv, bias, w_proj)
    _bf16_close(fused_axial_attention(x, axis, *args, b_proj, heads, scale),
                axial_attention_plain(x, axis, *args, b_proj, heads, scale, mxu_dtype=BF16),
                TOL_BF16)
    _bf16_close(fused_axial_attention_bwd_dx(x, g, axis, *args, heads, scale),
                axial_attention_bwd_dx_plain(x, g, axis, *args, heads, scale, mxu_dtype=BF16),
                3e-2)


@pytest.mark.parametrize("shape", [(1, 6, 16, 16, 128), (1, 6, 8, 8, 256)])
def test_resblock_bf16_forms_match_plain(dev, shape):
    C = shape[-1]
    k1, k2 = (_r(dev, C, C, 3, 3, 3, scale=(27 * C) ** -0.5) for _ in range(2))
    vecs = [_r(dev, C, scale=0.1, shift=s) for s in (0.0, 0.0, 1.0, 0.0, 1.0, 0.0)]
    x, emb, g = _r(dev, *shape, scale=0.5), _r(dev, 1, C, scale=0.3), _r(dev, *shape)
    args = (x, emb, k1, vecs[0], k2, vecs[1], *vecs[2:])
    out, h2 = fused_resblock_fwd(*args, 32)
    _bf16_close(out, resblock_plain(*args, 32, mxu_dtype=BF16)[0], 3e-2)
    dx, demb = fused_resblock_bwd(x, emb, k1, k2, *vecs[2:], h2, g, 32)
    want_dx, _ = resblock_bwd_plain(x, emb, k1, k2, *vecs[2:], h2.float(), g, 32, mxu_dtype=BF16)
    _bf16_close(dx, want_dx, 3e-2)
    assert demb.dtype == torch.float32 and torch.isfinite(demb).all()


def test_conv_bf16_form_matches_plain(dev):
    x, g = _r(dev, 1, 6, 16, 16, 128), _r(dev, 1, 6, 16, 16, 128)
    w, b = _r(dev, 128, 128, 3, 3, 3, scale=(27 * 128) ** -0.5), _r(dev, 128, scale=0.1)
    _bf16_close(conv3x3x3_forward(x, w, b), conv3x3x3_plain(x, w, b), 1e-3)
    _bf16_close(conv3x3x3_dx(g, w), conv3x3x3_dx_plain(g, w), 1e-3)


def test_bf16_guidance_runs_the_bf16_forms(dev):
    """A guidance shift with guidance in bf16 on an f32 carry at full width:
    every kernel launch is a bf16 form."""
    from prediff_torch.config import prediff_default_config
    from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
    from prediff_torch.factory import build_alignment_model
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    net = init_params_(build_alignment_model(cfg), torch.Generator().manual_seed(0),
                       randomize=True).to(dev).eval().requires_grad_(False)
    ka = KnowledgeAlignment(net, compute_dtype="bfloat16")
    z = torch.randn((1,) + tuple(cfg.model.align.model_args.input_shape), device=dev)
    fns = (fused_groupnorm_silu, fused_groupnorm_silu_bwd_full, fused_ffn, fused_ffn_bwd_dx,
           fused_axial_attention, fused_axial_attention_bwd_dx, fused_resblock_fwd,
           fused_resblock_bwd)
    before = [(fn.launches, fn.bf16_launches) for fn in fns]
    shift = ka.get_mean_shift(z, torch.tensor([500], device=dev), torch.tensor([[0.5]], device=dev))
    assert shift.dtype == torch.float32 and torch.isfinite(shift).all()
    for fn, (n, n16) in zip(fns, before):
        assert fn.launches - n == fn.bf16_launches - n16 > 0, fn.__name__


# The bf16 forms of the general layer, its input gradient and the grouped core
# (a forecast on bf16 parameters; bf16 guidance on a non-axial net), at the
# tiny swin shapes: each against its plain version on the same bf16 inputs.
@pytest.mark.parametrize("shape", [(1, 6, 64, 64), (2, 5, 36, 64), (1, 4, 64, 128)])
def test_cuboid_layer_bf16_forms_match_plain(dev, shape):
    C, vol, heads = shape[-1], shape[2], 4
    x, g = _r(dev, *shape), _r(dev, *shape)
    ln_w, ln_b = _r(dev, C, shift=1.0, scale=0.1), _r(dev, C, scale=0.1)
    w_qkv, w_proj = _r(dev, 3 * C, C, scale=C ** -0.5), _r(dev, C, C, scale=C ** -0.5)
    bias, b_proj = torch.randn(heads, vol, vol, device=dev) * 0.5, _r(dev, C, scale=0.1)
    scale = (C // heads) ** -0.5
    args = (ln_w, ln_b, w_qkv, bias, w_proj)
    counted = (fused_cuboid_attention_layer, fused_cuboid_attention_layer_bwd_dx)
    before = [fn.bf16_launches for fn in counted]
    _bf16_close(fused_cuboid_attention_layer(x, *args, b_proj, heads, scale),
                cuboid_attention_plain(x, *args, b_proj, heads, scale, mxu_dtype=BF16), TOL_BF16)
    _bf16_close(fused_cuboid_attention_layer_bwd_dx(x, g, *args, heads, scale),
                cuboid_attention_bwd_dx_plain(x, g, *args, heads, scale, mxu_dtype=BF16), 3e-2)
    assert [fn.bf16_launches for fn in counted] == [n + 1 for n in before]


@pytest.mark.parametrize("shape,window", [
    ((1, 2, 8, 64, 16), ((2, 16, 16), (1, 8, 8), (0, 4, 4), "zeros")),
    ((2, 2, 12, 32, 32), ((5, 6, 6), (2, 4, 4), (0, 0, 0), "ignore")),
    ((1, 2, 3, 20, 12), None)])
def test_grouped_bf16_form_matches_plain(dev, shape, window):
    """The bf16 form computes the f32 form's sums on the widened inputs (k
    and v are exact in TF32): its output is the f32 kernel's rounded once."""
    heads, nC, vol, hc = shape[1:]
    q, k, v = (_r(dev, *shape) for _ in range(3))
    bias = torch.randn(heads, vol, vol, device=dev) * 0.5
    mask = None if window is None else torch.from_numpy(compute_cuboid_self_attention_mask(
        window[0], window[1], window[2], ("l", "l", "l"), window[3])).to(dev)
    n0 = fused_cuboid_attention_grouped.bf16_launches
    got = fused_cuboid_attention_grouped(q, k, v, bias, mask, hc ** -0.5)
    want = grouped_attention_plain(q, k, v, bias, mask, hc ** -0.5)
    _bf16_close(got, want, 1e-5)
    f32 = fused_cuboid_attention_grouped(q.float(), k.float(), v.float(), bias, mask, hc ** -0.5)
    assert torch.equal(got, f32.to(BF16))
    assert fused_cuboid_attention_grouped.bf16_launches == n0 + 1


def test_bf16_parameters_on_an_f32_carry_give_the_f32_pipeline_on_rounded_weights(dev):
    """Promotion: bf16 parameters on an f32 carry run the f32 network on a
    copy of the bf16-rounded weights, so the forecast (unguided DDPM and
    guided DDIM, on graphs) is the f32 pipeline's from cast_to_fp32 of the
    same bf16 tree, bit for bit; the bf16 carry gives a bf16 latent."""
    from pathlib import Path

    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.precision import cast_to_bf16, cast_to_fp32

    cfg = load_config(prediff_default_config,
                      str(Path(__file__).resolve().parents[1] / "configs" / "tiny_smoke.yaml"))
    gen = torch.Generator().manual_seed(0)
    params = cast_to_bf16({k: init_params_(build(cfg), gen, randomize=True).state_dict()
                           for k, build in (("unet", build_unet), ("vae", build_vae),
                                            ("align", build_alignment_model))})
    p16 = PreDiffPredictor(cfg, params=params, device=dev)
    p32 = PreDiffPredictor(cfg, params=cast_to_fp32(params), device=dev)
    assert next(p16.ld.unet.parameters()).dtype == BF16
    y = torch.rand((1, 3, 32, 32, 1), generator=gen)
    for kw in (dict(timesteps=5), dict(ddim_steps=3, use_alignment=True, avg_x_gt=[[0.5]])):
        a, b = (p.predict(y, generator=torch.Generator(dev).manual_seed(3), **kw)
                for p in (p16, p32))
        assert a.dtype == torch.float32 and torch.isfinite(a).all() and torch.equal(a, b)
    p16.compute_dtype = "bfloat16"
    out = p16.ld.sample(y.to(dev), timesteps=3, return_decoded=False, compute_dtype="bfloat16",
                        generator=torch.Generator(dev).manual_seed(3))
    assert out.dtype == BF16 and torch.isfinite(out.float()).all()


@pytest.mark.parametrize("M,C", [(3328, 256), (832, 512), (100, 128)])
@pytest.mark.parametrize("act", ["relu", "leaky", "silu"])
def test_ffn_kernels_on_each_activation_match_plain(dev, M, C, act):
    """Every FFN kernel (the forward, dx, all gradients, the dropout forms,
    the bf16 forward and dx) on relu / leaky / silu against its plain version
    with the GELU forms' bars; each counts under ``<act>_launches``."""
    x, ln_w, ln_b, w1, b1, w2, b2 = args = _ffn_args(dev, M, C)
    g = torch.randn(M, C, device=dev)
    bf16, kw = torch.bfloat16, dict(activation=act)
    names = (fused_ffn, fused_ffn_bwd_dx, fused_ffn_bwd_full, fused_ffn_dropout,
             fused_ffn_dropout_bwd_full)
    before = [getattr(f, f"{act}_launches") for f in names]
    _close_bf16(fused_ffn(*args, **kw), ffn_plain(*args, mxu_dtype=bf16, **kw))
    bwd = (x, g, ln_w, ln_b, w1, b1, w2)
    _close_rel(fused_ffn_bwd_dx(*bwd, **kw), ffn_bwd_dx_plain(*bwd, mxu_dtype=bf16, **kw))
    for gt, wt in zip(fused_ffn_bwd_full(*bwd, **kw),
                      ffn_bwd_full_plain(*bwd, mxu_dtype=bf16, **kw)):
        _close_rel(gt, wt)
    drop = (0.1, 0.1, 7, 3)
    _close_bf16(fused_ffn_dropout(*args, 1e-5, *drop, **kw),
                ffn_dropout_plain(*args, 1e-5, *drop, mxu_dtype=bf16, **kw))
    for gt, wt in zip(fused_ffn_dropout_bwd_full(*bwd, 1e-5, *drop, **kw),
                      ffn_dropout_bwd_full_plain(*bwd, 1e-5, *drop, mxu_dtype=bf16, **kw)):
        _close_rel(gt, wt)
    assert [getattr(f, f"{act}_launches") for f in names] == [b + 1 for b in before]
    xb, gb, w1b, w2b = (t.to(bf16) for t in (x, g, w1, w2))
    got = fused_ffn(xb, ln_w, ln_b, w1b, b1, w2b, b2, **kw)
    assert got.dtype == bf16
    want = ffn_plain(xb, ln_w, ln_b, w1b, b1, w2b, b2, mxu_dtype=bf16, **kw)
    _close_rel(got.float(), want.float())
    got = fused_ffn_bwd_dx(xb, gb, ln_w, ln_b, w1b, b1, w2b, **kw)
    _close_rel(got.float(), ffn_bwd_dx_plain(xb, gb, ln_w, ln_b, w1b, b1, w2b, mxu_dtype=bf16,
                                             **kw).float())
    with pytest.raises(ValueError, match="activation"):
        fused_ffn(*args, activation="tanh")


@pytest.mark.parametrize("base", [(0, 0), (2 ** 32 + 4 * 1234, 4 * 5678)])
def test_dropout_kernels_on_a_device_seed_give_the_int_seed_bits(dev, base):
    """Rows 15a-15d and the general layer's dropout forms with the seed read
    from the card (``ops/dropout.device_seed``): bit-equal to the int-seed
    forms on the same seed, other bits on another device seed."""
    from prediff_torch.ops.dropout import device_seed

    seed = 0x5EED_0F_D20905
    dseed, other = device_seed(seed, dev), device_seed(seed + 1, dev)
    drop = (0.1, 0.1)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b)) if isinstance(a, tuple) \
            else torch.equal(a, b)

    args = _ffn_args(dev, 6656, 256)
    g = torch.randn(6656, 256, device=dev)
    bwd = (args[0], g) + args[1:6]
    for fn, a in ((fused_ffn_dropout, args + (1e-5,)), (fused_ffn_dropout_bwd_full, bwd + (1e-5,))):
        got = fn(*a, *drop, dseed, 3, bases=base)
        assert same(got, fn(*a, *drop, seed, 3, bases=base))
        assert not same(got, fn(*a, *drop, other, 3, bases=base))
    shape = (2, 13, 16, 16, 256)
    for axis in range(3):
        x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj = _attn_args(dev, shape, axis)
        fwd = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4, 0.125, 1e-5)
        bw = (x, torch.randn(*shape, device=dev), axis, ln_w, ln_b, w_qkv, bias, w_proj, 4, 0.125,
              1e-5)
        for fn, a in ((fused_axial_attention_dropout, fwd),
                      (fused_axial_attention_dropout_bwd_full, bw)):
            got = fn(*a, *drop, dseed, 3, bases=base)
            assert same(got, fn(*a, *drop, seed, 3, bases=base))
            assert not same(got, fn(*a, *drop, other, 3, bases=base))
    x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj = _cuboid_args(dev, (2, 52, 64, 256))
    fwd = (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, 4, 0.125, 1e-5)
    bw = (x, torch.randn_like(x), ln_w, ln_b, w_qkv, bias, w_proj, 4, 0.125, 1e-5)
    for fn, a in ((fused_cuboid_attention_layer_dropout, fwd),
                  (fused_cuboid_attention_layer_dropout_bwd_full, bw)):
        assert same(fn(*a, *drop, dseed, 3, bases=base), fn(*a, *drop, seed, 3, bases=base))


@pytest.mark.parametrize("optin", ["remat", "bf16_state"])
def test_captured_scan_with_an_optin_gives_the_bits_of_eager_steps(dev, optin):
    """``train_step_scan`` on the card with ``remat_unet`` (the checkpointed
    segments recomputed inside the captured backward) or with bf16 Adam
    moments and EMA shadow (``AdamStateDtype`` and the widened EMA on device
    scalars), the base_units-128 tiny UNet at depth [1,1], rates 0.1, accum
    2: two calls of K = 3 against six eager ``train_step`` calls from the same
    weights, bit for bit; each replay launches what an eager micro-step
    launches."""
    import numpy as np

    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    cfg = load_config(prediff_default_config, "configs/tiny_smoke.yaml")
    cfg.model.latent_model.update(base_units=128, depth=[1, 1], attn_drop=0.1, proj_drop=0.1,
                                  ffn_drop=0.1)
    kw = (dict(remat_unet=True) if optin == "remat"
          else dict(ema_dtype="bfloat16"))
    optim = dict(lr=1e-3, total_num_steps=10, accum_steps=2,
                 state_dtype=None if optin == "remat" else "bfloat16")
    L = cfg.layout
    it = synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height, L.img_width, seed=3)
    b = torch.from_numpy(np.stack([next(it) for _ in range(6)]))
    xs, ys = b[:, :, L.in_len:].contiguous(), b[:, :, :L.in_len].contiguous()
    states, metrics, per_micro = [], [], None
    for scan in (False, True):
        ld = build_training_pipeline(cfg, device=dev, seed=4)
        tr = DiffusionTrainer(ld, optim_config=optim, **kw)
        st = tr.create_state()
        got = []
        before = fused_ffn_dropout.launches
        if scan:
            for c in range(2):
                st, m = tr.train_step_scan(st, 9, xs[3 * c:3 * c + 3], ys[3 * c:3 * c + 3])
                got += [{k: v[i] for k, v in m.items()} for i in range(3)]
            per = {kind: d.get("fused_ffn_dropout", 0)
                   for kind, d in tr.scan_graphs.launches_per_replay().items()}
            assert per == {"accumulate": per_micro, "update": per_micro}
            assert fused_ffn_dropout.launches - before == 6 * per_micro
        else:
            for k in range(6):
                st, m = tr.train_step(st, 9, xs[k].to(dev), ys[k].to(dev))
                got.append(m)
            per_micro = (fused_ffn_dropout.launches - before) // 6
            assert per_micro > 0
        states.append(st)
        metrics.append(got)
    a, s = states
    assert a.counters() == s.counters() and (s.step, s.tx.count) == (6, 3)
    assert any(t.dtype == torch.bfloat16 for t in s.tensors()) == (optin == "bf16_state")
    assert all(u.dtype == v.dtype and torch.equal(u, v) for u, v in zip(a.tensors(), s.tensors()))
    assert all(torch.equal(metrics[0][i][k], metrics[1][i][k])
               for i in range(6) for k in metrics[0][i])


def test_a_chain_graph_replays_its_bits_after_a_scan_trainer_is_dropped(dev):
    """A forecast's captured chain, then a scan trainer that captures its
    micro-steps and is dropped, the cache given back and refilled: the
    chain's replays give the bits they gave before and write nothing into
    the refilled memory.  ``graphs.release_workspaces`` raises while the
    chain's graphs are alive and frees the cuBLAS workspaces once they are
    gone."""
    import gc

    import numpy as np

    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.diffusion.graphs import release_workspaces
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    predictor = _graph_predictor(dev)
    y = torch.rand((1, 3, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    kw = dict(timesteps=3, use_alignment=True, avg_x_gt=[[0.4]])
    first = predictor.predict(y, generator=torch.Generator(dev).manual_seed(5), **kw)
    captures = predictor.ld.graphs.captures

    cfg = load_config(prediff_default_config, "configs/tiny_smoke.yaml")
    cfg.model.latent_model.update(base_units=128, depth=[1, 1])
    L = cfg.layout
    it = synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height, L.img_width, seed=3)
    b = torch.from_numpy(np.stack([next(it) for _ in range(2)]))
    tr = DiffusionTrainer(build_training_pipeline(cfg, device=dev, seed=4),
                          optim_config=dict(lr=1e-3, total_num_steps=10))
    st, _ = tr.train_step_scan(tr.create_state(), 9, b[:, :, L.in_len:].contiguous(),
                               b[:, :, :L.in_len].contiguous())
    assert tr.scan_graphs.captures == 1
    del tr, st
    gc.collect()
    torch.cuda.empty_cache()
    junk = torch.full((1 << 28,), float("nan"), device=dev)   # reuses what the trainer freed
    second = predictor.predict(y, generator=torch.Generator(dev).manual_seed(5), **kw)
    assert predictor.ld.graphs.captures == captures and torch.equal(first, second)
    assert torch.isnan(junk).all()          # no replay wrote into memory it had given up
    with pytest.raises(RuntimeError, match="alive"):
        release_workspaces()
    del predictor, junk
    release_workspaces()


def test_captured_scan_gives_the_bits_of_eager_steps(dev):
    """``train_step_scan`` on the card (captured graphs, a base_units-128
    tiny UNet whose FFN and attention layers take the kernels, rates 0.1,
    accum 2): two calls of K = 3 against six eager ``train_step`` calls from
    the same weights, bit for bit; every replay adds its graph's launches."""
    import numpy as np

    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    cfg = load_config(prediff_default_config, "configs/tiny_smoke.yaml")
    cfg.model.latent_model.update(base_units=128, attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1)
    L = cfg.layout
    it = synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height, L.img_width, seed=3)
    b = torch.from_numpy(np.stack([next(it) for _ in range(6)]))
    xs, ys = b[:, :, L.in_len:].contiguous(), b[:, :, :L.in_len].contiguous()
    states, metrics = [], []
    for scan in (False, True):
        ld = build_training_pipeline(cfg, device=dev, seed=4)
        tr = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=10, accum_steps=2))
        st = tr.create_state()
        got = []
        if scan:
            before = fused_ffn_dropout.launches
            for c in range(2):
                st, m = tr.train_step_scan(st, 9, xs[3 * c:3 * c + 3], ys[3 * c:3 * c + 3])
                got += [{k: v[i] for k, v in m.items()} for i in range(3)]
            per = {kind: d.get("fused_ffn_dropout", 0)
                   for kind, d in tr.scan_graphs.launches_per_replay().items()}
            assert sorted(per) == ["accumulate", "update"] and len(set(per.values())) == 1
            assert fused_ffn_dropout.launches - before == 6 * per["update"] > 0
        else:
            for k in range(6):
                st, m = tr.train_step(st, 9, xs[k].to(dev), ys[k].to(dev))
                got.append(m)
        states.append(st)
        metrics.append(got)
    a, s = states
    assert (a.step, a.tx.count) == (s.step, s.tx.count) == (6, 3)
    assert all(torch.equal(u, v) for u, v in zip(a.tensors(), s.tensors()))
    assert all(torch.equal(metrics[0][i][k], metrics[1][i][k])
               for i in range(6) for k in metrics[0][i])
