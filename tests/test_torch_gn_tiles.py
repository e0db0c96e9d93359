"""What the one-launch GroupNorm+SiLU forward (``csrc/groupnorm.cu``
``gn_cluster_kernel``) is handed, on the CPU: the plans of
``ops/groupnorm.gn_plan`` cover every (sample, group, token, channel) once,
within a block's shared memory, at every shape of the kernels line and at
odd channels per group; the route to the two-pass kernels is taken by shape
alone; and a torch emulation of the kernel's order of arithmetic (Welford
per thread over its strided strip of the rank's tile, Chan merges down each
warp, across the warps in order, across the cluster's ranks in rank order)
against the JAX package's Pallas kernel in interpret mode on inputs whose
mean is far above their spread."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_groupnorm
from prediff_torch.ops import groupnorm
from prediff_torch.ops.groupnorm import GnPlan, gn_plan, groupnorm_silu_plain

# (B, N, C, groups): the kernels line's GN sites (UNet first_proj in / out and
# both stages at B=1 and the training micro-batch B=2, the alignment net's
# first_proj in / out), and odd channels per group (3 and 5)
SHAPES = [(1, 3328, 65, 65), (1, 3328, 256, 32), (1, 832, 512, 32), (2, 3328, 65, 65),
          (2, 3328, 256, 32), (2, 832, 512, 32), (1, 1536, 64, 32), (1, 1536, 128, 32),
          (1, 100, 96, 32), (2, 77, 65, 13)]
# f32 on both sides, the sums in another order; |mean| / std = 50 costs the
# normalised values ~50 ulp of the mean's scale (the inputs' own rounding)
TOL_F32_SHIFTED = 1e-4


@pytest.mark.parametrize("B,N,C,groups", SHAPES)
def test_plans_cover_every_value_once(B, N, C, groups):
    plan = gn_plan(B, N, C, groups)
    assert plan is not None and plan.cluster in (1, 2, 4, 8) and plan.cluster <= N
    seen = np.zeros((B, N, C), dtype=np.int64)
    for b in range(B):
        for g in range(groups):
            for rank in range(plan.cluster):
                sample, tokens, channels = plan.tile(b, g, rank)
                assert sample == b and len(channels) == plan.cpg
                assert len(tokens) <= plan.tpr
                seen[b, tokens.start:tokens.stop, channels.start:channels.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,N,C,groups", SHAPES)
def test_plans_fit_the_card(B, N, C, groups):
    plan = gn_plan(B, N, C, groups)
    assert plan.smem_bytes <= groupnorm.GN_SMEM_CAP
    assert plan.vw == (4 if (C // groups) % 4 == 0 else 1)
    # the smallest cluster that gives the target, or the largest there is
    smaller = GnPlan(B, N, C, groups, plan.cluster // 2)
    assert plan.blocks >= groupnorm.GN_TARGET_BLOCKS or plan.cluster == 8
    assert plan.cluster == 1 or smaller.blocks < groupnorm.GN_TARGET_BLOCKS


def test_plans_at_the_unet_shapes():
    """Clusters of 4 at B=1 (32 groups: 128 blocks; 65 one-channel groups: 2,
    130 blocks), of 2 at B=2; a stage-0 rank holds 832 tokens x 8 channels."""
    assert [gn_plan(*s).cluster for s in SHAPES[:6]] == [2, 4, 4, 1, 2, 2]
    s0 = gn_plan(1, 3328, 256, 32)
    assert (s0.tpr, s0.cpg, s0.blocks, s0.smem_bytes) == (832, 8, 128, 4 * (832 * 8 + 24))


def test_route_to_the_two_pass_kernels_is_by_shape():
    """A (sample, group) beyond a cluster of 8 blocks' shared memory takes the
    two-pass kernels (None); one beyond a single block's takes a larger
    cluster than the block target asks for."""
    assert gn_plan(1, 10 ** 6, 64, 32) is None         # 2 M values a group: 1 MB a rank
    assert gn_plan(1, 60000, 1024, 1) is None          # 61 M values
    wide = gn_plan(8, 50000, 64, 32)                   # 256 groups: the target wants 1
    assert wide.cluster == 2 and wide.smem_bytes <= groupnorm.GN_SMEM_CAP
    assert GnPlan(8, 50000, 64, 32, 1).smem_bytes > groupnorm.GN_SMEM_CAP


def _merge(a, b):
    """Chan's merge of (n, mean, M2) as ``merge`` in csrc/groupnorm.cu, f32."""
    an, am, a2 = a
    bn, bm, b2 = b
    n = an + bn
    d = bm - am
    wb = bn / torch.where(n == 0, torch.ones_like(n), n)
    empty = bn == 0
    return (n, torch.where(empty, am, am + d * wb),
            torch.where(empty, a2, a2 + b2 + d * d * an * wb))


def _emulate(x, w, b, emb, groups, eps=1e-5):
    """The kernel's arithmetic on (B, N, C) x, f32: per (sample, group, rank)
    the tile in shared memory order (token-major, the group's channels
    inner); thread t runs Welford (mean += d / n) over values t,
    t + 256, ...; the lanes of a warp merge down a shfl_down tree, the 8
    warps in order, the ranks in order; then v = (x + emb - mean) * rstd *
    gamma + beta and v / (1 + e^-v)."""
    B, N, C = x.shape
    plan = gn_plan(B, N, C, groups)
    cpg, tpr, ranks, T = plan.cpg, plan.tpr, plan.cluster, groupnorm.GN_THREADS
    v = x + (emb[:, None] if emb is not None else 0.0)
    v = v.reshape(B, N, groups, cpg).permute(0, 2, 1, 3)                  # (B, G, N, cpg)
    pad = ranks * tpr - N
    v = torch.cat([v, torch.full((B, groups, pad, cpg), float("nan"))], 2)
    tiles = v.reshape(B, groups, ranks, tpr * cpg)                        # smem order
    steps = -(-tiles.shape[-1] // T)
    tiles = torch.cat([tiles, torch.full((B, groups, ranks, steps * T - tiles.shape[-1]),
                                         float("nan"))], -1)
    strips = tiles.reshape(B, groups, ranks, steps, T)                     # value t + k T
    zero = torch.zeros(B, groups, ranks, T)
    n, mean, m2 = zero.clone(), zero.clone(), zero.clone()
    for k in range(steps):
        val = strips[..., k, :]
        ok = ~torch.isnan(val)
        val = torch.where(ok, val, torch.zeros_like(val))
        n1 = torch.where(ok, n + 1.0, n)
        d = val - mean
        mean1 = torch.where(ok, mean + d / torch.where(ok, n1, torch.ones_like(n1)), mean)
        m2 = torch.where(ok, m2 + d * (val - mean1), m2)
        n, mean = n1, mean1
    st = tuple(t.reshape(B, groups, ranks, T // 32, 32) for t in (n, mean, m2))
    for o in (16, 8, 4, 2, 1):
        st = _merge(tuple(t[..., :o] for t in st), tuple(t[..., o:2 * o] for t in st))
    st = tuple(t[..., 0] for t in st)                                     # (B, G, ranks, warps)
    acc = tuple(t[..., 0] for t in st)
    for wp in range(1, T // 32):
        acc = _merge(acc, tuple(t[..., wp] for t in st))
    tot = tuple(t[..., 0] for t in acc)
    for r in range(1, ranks):
        tot = _merge(tot, tuple(t[..., r] for t in acc))
    mean_g = tot[1][:, None, :, None]
    rstd_g = torch.rsqrt(tot[2] / tot[0] + eps)[:, None, :, None]
    xv = (x + (emb[:, None] if emb is not None else 0.0)).reshape(B, N, groups, cpg)
    y = ((xv - mean_g) * rstd_g).reshape(B, N, C) * w + b
    return y / (1.0 + torch.exp(-y))


def _inputs(B, N, C, seed, with_emb, scale=0.2, shift=10.0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, N, C) * scale + shift).astype(np.float32)    # |mean| / std = 50
    w = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    emb = (0.1 * rs.randn(B, C)).astype(np.float32) if with_emb else None
    return x, w, b, emb


@pytest.mark.parametrize("B,N,C,groups,with_emb", [(2, 416, 128, 32, True),
                                                   (1, 832, 256, 32, False)])
def test_emulated_kernel_matches_the_interpret_kernel(B, N, C, groups, with_emb):
    """Clusters of 2 and 4 ranks (the cross-rank merge runs), 4 and 8
    channels a group, |mean| / std = 50."""
    x, w, b, emb = _inputs(B, N, C, 60 + B, with_emb)
    assert gn_plan(B, N, C, groups).cluster == (2 if B == 2 else 4)
    want = np.asarray(pallas_groupnorm.fused_groupnorm_silu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), None if emb is None else jnp.asarray(emb),
        groups=groups, interpret=True))
    t = [None if a is None else torch.from_numpy(a) for a in (x, w, b, emb)]
    got = _emulate(*t, groups).numpy()
    assert np.abs(got.astype(np.float64) - want).max() <= TOL_F32_SHIFTED


@pytest.mark.parametrize("B,N,C,groups", [(1, 333, 96, 32), (2, 77, 65, 13), (1, 40, 65, 65)])
def test_emulated_kernel_matches_the_plain_version_at_odd_shapes(B, N, C, groups):
    """Odd channels a group (3, 5, 1), ragged last ranks, against the plain
    version (two-pass statistics) at the same bar."""
    x, w, b, emb = (None if a is None else torch.from_numpy(a)
                    for a in _inputs(B, N, C, 70 + N, True))
    got = _emulate(x, w, b, emb, groups)
    want = groupnorm_silu_plain(x, w, b, emb, groups)
    assert float((got - want).abs().max()) <= TOL_F32_SHIFTED
