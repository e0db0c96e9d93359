"""What the bf16 3x3x3 conv kernel is handed, on the CPU: the tile plan of
``ops/conv3d.conv_plan`` (token boxes, their origins, ragged edges, the
cluster's split of the reduction) and the bf16 weight layouts of
``ops/conv3d.weight_layout`` with their per-version cache.  A torch emulation
of the kernel's implicit GEMM, gathering each tap's rows by those boxes with
zeros outside the volume and adding the split partials in rank order, is held
to the plain conv.  No JAX: the plain versions are the reference."""
import gc
import io
import weakref

import numpy as np
import pytest
import torch

from prediff_torch.ops import conv3d

# the volumes of the UNet's stages (B=1 and the training micro-batch), the
# alignment net's and the JAX package's own test volume
VOLUMES = [(1, 13, 16, 16), (1, 13, 8, 8), (2, 13, 8, 8), (1, 6, 16, 16), (1, 5, 8, 8)]
# bf16 operands rounded from the same f32 values on both sides, f32 sums in
# another order
TOL = 1e-5


def _box_tokens(plan, m_tile):
    """(sample, t, h, w) of each of the box's ``TOKEN_TILE`` rows, in the
    kernel's row order, and whether it lies in the volume."""
    b, t0, h0, w0 = plan.origin(m_tile)
    bt, bh, bw = plan.box
    r = np.arange(conv3d.TOKEN_TILE)
    t, h, w = t0 + r // (bh * bw), h0 + (r // bw) % bh, w0 + r % bw
    inside = (t < plan.T) & (h < plan.H) & (w < plan.W)
    return b, t, h, w, inside


@pytest.mark.parametrize("vol", VOLUMES)
def test_boxes_cover_every_token_once(vol):
    B, T, H, W = vol
    plan = conv3d.conv_plan(B, T, H, W, 128, 256)
    assert np.prod(plan.box) == conv3d.TOKEN_TILE
    seen = np.zeros((B, T, H, W), dtype=np.int64)
    for m in range(plan.m_tiles):
        b, t, h, w, inside = _box_tokens(plan, m)
        assert 0 <= b < B   # a box is one sample's: it never straddles two
        assert (t[inside] >= 0).all() and (h[inside] >= 0).all() and (w[inside] >= 0).all()
        np.add.at(seen, (b, t[inside], h[inside], w[inside]), 1)
    assert (seen == 1).all()
    assert plan.n_tile * plan.n_tiles == 256
    # the split covers the 27 x K / 64 slices once, in rank order
    slices = [i for r in range(plan.splits) for i in plan.split_slices(r)]
    assert slices == list(range(plan.slices))
    assert plan.splits in conv3d.SPLITS


def test_plan_at_the_unet_shapes():
    """The boxes the kernel's note names, and the blocks at each UNet shape."""
    stage0 = conv3d.conv_plan(1, 13, 16, 16, 256, 256)
    stage1 = conv3d.conv_plan(1, 13, 8, 8, 512, 512)
    assert stage0.box == (1, 8, 16) and stage0.m_tiles * stage0.n_tiles == 26
    assert stage1.box == (2, 8, 8) and stage1.m_tiles * stage1.n_tiles == 14
    assert (stage0.splits, stage1.splits) == (4, 8)
    for plan in (stage0, stage1):   # one wave, at least three quarters of the SMs busy
        assert 0.75 * conv3d.SMS <= plan.m_tiles * plan.n_tiles * plan.splits <= conv3d.SMS


@pytest.mark.parametrize("K,N", [(96, 128), (128, 192), (32, 128), (64, 64)])
def test_plan_refuses_channels_the_kernel_does_not_take(K, N):
    with pytest.raises(ValueError, match="not supported"):
        conv3d.conv_plan(1, 5, 8, 8, K, N)


def _emulate(x, layout, bias, plan):
    """The kernel's arithmetic in torch: for each token tile, channel tile and
    split rank, the sum over its (tap, 64-channel) slices of the box gathered
    at the tap's offset (zeros outside the volume) times the weights' tile;
    the partials added in rank order, the bias, rows outside the volume
    dropped."""
    B, T, H, W, K = x.shape
    bt, bh, bw = plan.box
    nbt, nbh, nbw = plan.boxes
    # zeros around the volume and past the last box
    xp = torch.zeros(B, nbt * bt + 2, nbh * bh + 2, nbw * bw + 2, K)
    xp[:, 1:T + 1, 1:H + 1, 1:W + 1] = x.to(torch.bfloat16).float()
    w = layout.float()                                    # (27, N, K)
    out = torch.zeros(B, T, H, W, plan.N)
    for m in range(plan.m_tiles):
        b, t, h, ww, inside = _box_tokens(plan, m)
        for n in range(plan.n_tiles):
            cols = slice(n * plan.n_tile, (n + 1) * plan.n_tile)
            total = None
            for rank in range(plan.splits):
                part = torch.zeros(conv3d.TOKEN_TILE, plan.n_tile)
                for i in plan.split_slices(rank):
                    tap, c0 = divmod(i, K // conv3d.K_SLICE)
                    c = slice(c0 * conv3d.K_SLICE, (c0 + 1) * conv3d.K_SLICE)
                    dt, dh, dw = tap // 9, (tap // 3) % 3, tap % 3   # offsets + 1 in xp
                    a = xp[b, t + dt, h + dh, ww + dw, c]
                    part += a @ w[tap, cols, c].T
                total = part if total is None else total + part
            if bias is not None:
                total = total + bias[cols]
            out[b, t[inside], h[inside], ww[inside], cols] = total[torch.from_numpy(inside)]
    return out


@pytest.mark.parametrize("vol", VOLUMES)
def test_emulated_kernel_matches_the_plain_conv(vol):
    B, T, H, W = vol
    rs = np.random.RandomState(sum(vol))
    C, OC = 64, 128
    x = torch.from_numpy(rs.randn(B, T, H, W, C).astype(np.float32))
    w = torch.from_numpy((rs.randn(OC, C, 3, 3, 3) / (27 * C) ** 0.5).astype(np.float32))
    b = torch.from_numpy((0.1 * rs.randn(OC)).astype(np.float32))
    got = _emulate(x, conv3d.weight_layout(w), b, conv3d.conv_plan(B, T, H, W, C, OC))
    want = conv3d.conv3x3x3_plain(x, w, b)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    # the input gradient: the same emulation on the cotangent and the dx layout
    C, OC = 128, 64
    g = torch.from_numpy(rs.randn(B, T, H, W, OC).astype(np.float32))
    w = torch.from_numpy((rs.randn(OC, C, 3, 3, 3) / (27 * C) ** 0.5).astype(np.float32))
    got = _emulate(g, conv3d.weight_layout(w, dx=True), None, conv3d.conv_plan(B, T, H, W, OC, C))
    want = conv3d.conv3x3x3_dx_plain(g, w)
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


@pytest.mark.parametrize("dx", [False, True])
def test_weight_layouts_are_the_kernel_layouts_in_bf16(dx):
    w = torch.randn(256, 128, 3, 3, 3)
    want = conv3d.conv_weight_t(w) if dx else conv3d.conv_weight(w)   # (27, K, N)
    got = conv3d.weight_layout(w, dx=dx)                              # (27, N, K)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got, want.transpose(1, 2).to(torch.bfloat16))


def test_layout_is_made_once_per_parameter_version():
    conv = torch.nn.Conv3d(128, 128, 3, padding=1)
    p = conv.weight
    first, first_dx = conv3d.weight_layout(p), conv3d.weight_layout(p, dx=True)
    assert conv3d.weight_layout(p) is first and conv3d.weight_layout(p, dx=True) is first_dx
    with torch.no_grad():
        p.add_(1.0)
    second = conv3d.weight_layout(p)
    assert second is not first
    assert torch.equal(second, conv3d.conv_weight(p.detach()).transpose(1, 2).to(torch.bfloat16))
    assert conv3d.weight_layout(p) is second
    opt = torch.optim.AdamW(conv.parameters(), lr=1e-2)
    conv(torch.randn(1, 128, 3, 4, 4)).square().mean().backward()
    opt.step()
    third = conv3d.weight_layout(p)
    assert third is not second
    assert torch.equal(third, conv3d.conv_weight(p.detach()).transpose(1, 2).to(torch.bfloat16))
    assert conv3d.weight_layout(p, dx=True) is not first_dx


def test_layout_goes_with_its_module():
    conv = torch.nn.Conv3d(128, 128, 3, padding=1)
    ref = weakref.ref(conv3d.weight_layout(conv.weight))
    assert ref() is not None
    del conv
    gc.collect()
    assert ref() is None


def test_cached_parameters_still_save():
    """The cache lives beside the parameter, not on it: a checkpoint of the
    module's parameters pickles as before."""
    conv = torch.nn.Conv3d(128, 128, 3, padding=1)

    def saved():
        buf = io.BytesIO()
        torch.save({"w": conv.weight, "sd": conv.state_dict()}, buf)
        return buf

    before = saved().getbuffer().nbytes
    conv3d.weight_layout(conv.weight)
    conv3d.weight_layout(conv.weight, dx=True)
    buf = saved()
    assert buf.getbuffer().nbytes == before   # no layout travels with the parameter
    buf.seek(0)
    assert torch.equal(torch.load(buf)["w"], conv.weight)
