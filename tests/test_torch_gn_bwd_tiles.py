"""What the cluster backward of GroupNorm+SiLU (``csrc/gn_cluster.cuh``
``bwd_kernel``: the all-gradients backward of ``csrc/groupnorm.cu`` and the
resblock's GN passes) is handed, on the CPU: the plans of
``ops/groupnorm.gn_bwd_plan`` cover every (sample, group, token, channel)
once with a rank's two f32 tiles within a block's shared memory, give the
cluster sizes the training and alignment shapes need, and route to the
one-block-per-group kernels by shape alone; ``ops/resblock.gn_tiles`` is
that plan and hands the resblock the clusters it had; and a torch emulation
of the kernel's order of arithmetic (Welford per thread over its vectors,
Chan merges down the warp, across the warps and the ranks in order; the
block sums of u and u * xhat in the kernel's fixed tree, added over the ranks
in order; dgamma, dbeta and demb over the block's threads of each channel in
a fixed tree and then the ranks in order) against the JAX package's Pallas kernel in
interpret mode and the plain version, on inputs whose mean is far above
their spread."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_groupnorm
from prediff_torch.ops import groupnorm
from prediff_torch.ops.groupnorm import GnPlan, gn_bwd_plan, groupnorm_silu_bwd_full_plain
from prediff_torch.ops.resblock import gn_tiles

# (B, N, C, groups) -> (cluster, blocks, bytes of the two tiles): the training
# micro-step's GN sites at B=2 and the alignment net's first_proj at B=1
# (the 65 one-channel groups eight to a block: 9 units, so clusters of 8)
TABLE = {(2, 3328, 256, 32): (2, 128, 106496), (2, 832, 512, 32): (2, 128, 53248),
         (2, 3328, 65, 65): (8, 144, 26624), (1, 1536, 64, 32): (4, 128, 6144),
         (1, 1536, 128, 32): (4, 128, 12288)}
# those, the forecast's B=1 sites, and ragged or small shapes
SHAPES = list(TABLE) + [(1, 3328, 256, 32), (1, 832, 512, 32), (1, 3328, 65, 65),
                        (1, 301, 128, 16), (2, 77, 64, 32)]
# f32 on both sides, the sums in another order; |mean| / std = 50 costs the
# normalised values ~50 ulp of the mean's scale (the inputs' own rounding):
# 1e-4 of each output's scale, as the card's check holds the kernel
TOL_F32_SHIFTED = 1e-4
T = groupnorm.GN_THREADS


@pytest.mark.parametrize("B,N,C,groups", SHAPES)
def test_plans_cover_every_value_once_within_shared_memory(B, N, C, groups):
    plan = gn_bwd_plan(B, N, C, groups)
    assert plan.tiles == 2 and plan.cluster in (1, 2, 4, 8) and plan.cluster <= N
    assert plan.bundle == (groupnorm.GN_BUNDLE if plan.cpg == 1 else 1)
    assert plan.smem_bytes == 4 * (2 * plan.tpr * plan.width + 3 * plan.width)
    assert plan.smem_bytes <= groupnorm.GN_BWD_SMEM_CAP
    # a thread stays on vw fixed channels; 16-byte copies where cpg allows
    assert plan.vw == (4 if plan.cpg % 4 == 0 else 1) and (T * plan.vw) % plan.width == 0
    seen = np.zeros((B, N, C), dtype=np.int64)
    for b in range(B):
        for unit in range(plan.units):
            for rank in range(plan.cluster):
                sample, tokens, channels = plan.tile(b, unit, rank)
                assert sample == b and len(channels) <= plan.width and len(tokens) <= plan.tpr
                seen[b, tokens.start:tokens.stop, channels.start:channels.stop] += 1
    assert (seen == 1).all()
    # the smallest cluster that gives the target, or the largest there is
    smaller = GnPlan(B, N, C, groups, plan.cluster // 2, 2, plan.bundle)
    assert plan.blocks >= groupnorm.GN_TARGET_BLOCKS or plan.cluster == 8
    assert (plan.cluster == 1 or smaller.blocks < groupnorm.GN_TARGET_BLOCKS
            or smaller.smem_bytes > groupnorm.GN_BWD_SMEM_CAP)


def test_plans_at_the_path_shapes():
    got = {s: (p.cluster, p.blocks, 8 * p.tpr * p.width)
           for s, p in ((s, gn_bwd_plan(*s)) for s in TABLE)}
    assert got == TABLE


def test_route_to_the_one_block_kernels_is_by_shape():
    """None (the one-block-per-group kernels) where a (sample, group) is past
    a cluster of 8 blocks' shared memory, or where a 256-thread block cannot
    keep each thread on fixed channels (3 or 5 a group); a rank past one
    block's memory takes a larger cluster than the block target asks for."""
    assert gn_bwd_plan(1, 240000, 64, 32) is None      # 480 KB a rank at 8 ranks
    assert gn_bwd_plan(1, 60000, 1024, 1) is None
    assert gn_bwd_plan(3, 50, 96, 32) is None          # 3 channels a group
    assert gn_bwd_plan(2, 77, 65, 13) is None          # 5
    assert gn_bwd_plan(1, 100, 1024, 1).vw == 4        # 1024 channels: 4 a thread
    assert gn_bwd_plan(1, 100, 64, 64).bundle == 8     # one channel a group: 8 a block
    wide = gn_bwd_plan(8, 20000, 64, 32)               # 256 groups: the target wants 1
    assert wide.cluster == 2 and wide.smem_bytes <= groupnorm.GN_BWD_SMEM_CAP
    assert GnPlan(8, 20000, 64, 32, 1, 2).smem_bytes > groupnorm.GN_BWD_SMEM_CAP
    # the forward's plan is the same rule for one tile: it holds twice the tokens
    assert groupnorm.gn_plan(1, 160000, 64, 32) is not None
    assert gn_bwd_plan(1, 160000, 64, 32) is None


def _old_gn_tiles(B, N, C, groups):
    """``ops/resblock.gn_tiles`` as it stood before it became a call of the
    shared plan: two f32 tiles a rank beside 2 KB of the kernel's own."""
    cpg = C // groups
    sizes = [r for r in (1, 2, 4, 8) if r <= max(N, 1)]
    want = next((r for r in sizes if B * groups * r >= 128), sizes[-1])
    for r in sizes:
        tpr = -(-N // r)
        if r >= want and 8 * tpr * cpg <= 232448 - 1024 - 2048:
            return r, tpr
    return 0, 0


@pytest.mark.parametrize("B", [1, 2])
def test_resblock_gets_the_clusters_it_had(B):
    """The alignment net's stage blocks (1536 and 384 tokens, 128 and 256
    channels), a 64-channel block and one past a cluster's memory."""
    for N, C in ((1536, 128), (384, 256), (60, 64), (240000, 64)):
        assert gn_tiles(B, N, C, 32) == _old_gn_tiles(B, N, C, 32)
    assert gn_tiles(1, 1536, 128, 32) == (4, 384)


def _merge(a, b):
    """Chan's merge of (n, mean, M2) as ``merge`` in csrc/welford.cuh, f32."""
    an, am, a2 = a
    bn, bm, b2 = b
    n = an + bn
    d = bm - am
    wb = bn / torch.where(n == 0, torch.ones_like(n), n)
    empty = bn == 0
    return (n, torch.where(empty, am, am + d * wb),
            torch.where(empty, a2, a2 + b2 + d * d * an * wb))


def _block_sum(v):
    """``block_sum`` of gn_cluster.cuh over the last axis (256 threads): an xor
    tree in each warp, then the 8 warps' sums (zeros to 32) by the same tree."""
    lanes = torch.arange(32)
    w = v.reshape(*v.shape[:-1], T // 32, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[..., lanes ^ o]
    r = torch.cat([w[..., 0], torch.zeros(*w.shape[:-2], 32 - T // 32)], -1)
    for o in (16, 8, 4, 2, 1):
        r = r + r[..., lanes ^ o]
    return r[..., 0]


def _emulate(x, g, w, b, emb, groups, eps=1e-5):
    """The kernel's arithmetic on (B, N, C) x and g, f32: (dx, dgamma, dbeta,
    demb or None).  Per (sample, unit, rank) the tiles in shared memory order
    (token-major, the unit's channels inner, zeros past C) as vectors of vw
    values; thread t takes vectors t, t + 256, ... and stays on channels
    (t % cw) * vw ..; a unit is a group, or 8 one-channel groups whose
    statistics and sums of u and u xhat are per channel."""
    B, N, C = x.shape
    plan = gn_bwd_plan(B, N, C, groups)
    U, width, tpr, R, vw = plan.units, plan.width, plan.tpr, plan.cluster, plan.vw
    cw = width // vw
    nc = cw if plan.bundle > 1 else 1        # groups in a tile
    steps = -(-(tpr * cw) // T)
    cp = U * width                           # channels padded to whole units

    def tiles(a):   # (B, N, C) -> (B, U, R, steps, T, vw), zeros past C and a rank's tokens
        a = torch.cat([a, torch.zeros(B, N, cp - C)], 2).reshape(B, N, U, width)
        a = torch.cat([a.permute(0, 2, 1, 3), torch.zeros(B, U, R * tpr - N, width)], 2)
        a = a.reshape(B, U, R, tpr * cw, vw)
        a = torch.cat([a, torch.zeros(B, U, R, steps * T - tpr * cw, vw)], 3)
        return a.reshape(B, U, R, steps, T, vw)

    xt, gt = tiles(x), tiles(g)
    nt = torch.tensor([max(0, min(tpr, N - r * tpr)) for r in range(R)])
    vec = torch.arange(steps)[:, None] * T + torch.arange(T)[None, :]
    valid = (vec[None] < (nt * cw)[:, None, None])[None, None, ..., None].expand(xt.shape)
    chan = (torch.arange(T) % cw)[:, None] * vw + torch.arange(vw)[None, :]      # (T, vw)
    chan = torch.arange(U)[:, None, None] * width + chan[None]                     # (U, T, vw)
    live, chan = chan < C, chan.clamp(max=C - 1)
    e = torch.where(live, (emb if emb is not None else torch.zeros(B, C))[:, chan], 0.0)
    e = e[:, :, None, None]
    gam = torch.where(live, w[chan], 0.0)[None, :, None, None]
    bet = torch.where(live, b[chan], 0.0)[None, :, None, None]

    zero = torch.zeros(B, U, R, T)
    n, mean, m2 = zero.clone(), zero.clone(), zero.clone()
    for k in range(steps):
        for j in range(vw):
            ok = valid[..., k, :, j]
            val = xt[..., k, :, j] + e[:, :, :, 0, :, j]
            n1 = torch.where(ok, n + 1.0, n)
            d = val - mean
            mean1 = torch.where(ok, mean + d / torch.where(ok, n1, torch.ones_like(n1)), mean)
            m2 = torch.where(ok, m2 + d * (val - mean1), m2)
            n, mean = n1, mean1
    st = tuple(t.reshape(B, U, R, T // 32, 32) for t in (n, mean, m2))
    for o in (16, 8, 4, 2, 1):       # down the lanes of a group
        if o >= nc:
            st = _merge(tuple(t[..., :o] for t in st), tuple(t[..., o:2 * o] for t in st))
    acc = tuple(t[..., 0, :] for t in st)                                 # (B, U, R, nc)
    for wp in range(1, T // 32):
        acc = _merge(acc, tuple(t[..., wp, :] for t in st))
    tot = tuple(t[:, :, 0] for t in acc)
    for r in range(1, R):
        tot = _merge(tot, tuple(t[:, :, r] for t in acc))
    cls = torch.arange(T) % cw if nc > 1 else torch.zeros(T, dtype=torch.long)
    mean_t = tot[1][..., cls][:, :, None, None, :, None]                  # a thread's group
    rstd_t = torch.rsqrt(tot[2] / tot[0] + eps)[..., cls][:, :, None, None, :, None]

    xhat = (xt + e - mean_t) * rstd_t
    a = xhat * gam + bet
    sig = 1.0 / (1.0 + torch.exp(-a))
    dy = torch.where(valid, gt * (sig * (1.0 + a * (1.0 - sig))), torch.zeros_like(gt))
    u = dy * gam

    def per_thread(v):   # each thread's own sum over its vectors in order: (B, U, R, T, vw)
        out = torch.zeros(B, U, R, T, vw)
        for k in range(steps):
            out = out + v[..., k, :, :]
        return out

    def thread_sum(v):   # a thread's sum of all its values, vector by vector: (B, U, R, T)
        out = torch.zeros(B, U, R, T)
        for k in range(steps):
            for j in range(vw):
                out = out + v[..., k, :, j]
        return out

    def by_rank(v):      # added over the ranks in rank order
        out = torch.zeros_like(v[:, :, 0])
        for r in range(R):
            out = out + v[:, :, r]
        return out

    def per_channel(v):  # (B, U, R, T, vw) -> (B, U, width): threads of a channel, then ranks
        if cw < 32:      # the warp's lanes of a channel by an xor tree, then the warps in order
            v = v.reshape(B, U, R, T // 32, 32, vw)
            for o in (16, 8, 4, 2, 1):
                if o >= cw:
                    v = v + v[..., torch.arange(32) ^ o, :]
            v = v[..., :cw, :]
        v = v.reshape(B, U, R, -1, width)
        out = torch.zeros(B, U, R, width)
        for j in range(v.shape[3]):
            out = out + v[..., j, :]
        return by_rank(out)

    def group_sum(v):    # the block's (tree) or, in a bundle, the channel's sum, then ranks
        if nc == 1:
            return by_rank(_block_sum(thread_sum(v)))[:, :, None, None, None, None]
        return per_channel(thread_sum(v)[..., None])[..., cls][:, :, None, None, :, None]

    S1, S2 = group_sum(u), group_sum(u * xhat)
    dx = rstd_t * (u - (S1 + xhat * S2) / float(N * plan.cpg))
    dx = torch.where(valid, dx, torch.zeros_like(dx))

    def channels(v):
        return v.reshape(B, cp)[:, :C]

    dgamma = channels(per_channel(per_thread(dy * xhat)))
    dbeta = channels(per_channel(per_thread(dy)))
    demb = channels(per_channel(per_thread(dx))) if emb is not None else None
    dx = dx.reshape(B, U, R, steps * T * vw)[..., :tpr * width]
    dx = dx.reshape(B, U, R * tpr, width)[:, :, :N].permute(0, 2, 1, 3).reshape(B, N, cp)[..., :C]
    return dx, dgamma.sum(0), dbeta.sum(0), demb


def _inputs(B, N, C, seed, with_emb, scale=0.2, shift=10.0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, N, C) * scale + shift).astype(np.float32)    # |mean| / std = 50
    g = rs.randn(B, N, C).astype(np.float32)
    w = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    b = (0.1 * rs.randn(C)).astype(np.float32)
    emb = (0.1 * rs.randn(B, C)).astype(np.float32) if with_emb else None
    return x, g, w, b, emb


def _close(got, want):
    for gt, wt in zip(got, want):
        if wt is None:
            assert gt is None
            continue
        wt = np.asarray(wt, dtype=np.float64)
        err = np.abs(np.asarray(gt, dtype=np.float64) - wt).max()
        assert err <= TOL_F32_SHIFTED * max(np.abs(wt).max(), 1.0), err


@pytest.mark.parametrize("B,N,C,groups,with_emb,cluster", [(2, 416, 128, 32, True, 2),
                                                           (1, 832, 256, 32, False, 4),
                                                           (1, 320, 128, 128, False, 8)])
def test_emulated_kernel_matches_the_interpret_kernel(B, N, C, groups, with_emb, cluster):
    """Clusters of 2, 4 and 8 ranks (the cross-rank sums run), 4 and 8
    channels a group (16-byte copies) and one (eight groups a block, 4-byte
    copies; the JAX kernel takes C a multiple of 128), |mean| / std = 50.
    One channel a group goes without
    emb, as the UNet's one-channel site: there demb, the sum of dx over a
    group, cancels to ~0 and carries the mean's last-ulp error times rstd
    S2, in any f32 order (~1e-3 at these inputs)."""
    x, g, w, b, emb = _inputs(B, N, C, 80 + B, with_emb)
    assert gn_bwd_plan(B, N, C, groups).cluster == cluster
    want = pallas_groupnorm.fused_groupnorm_silu_bwd_full(
        *map(jnp.asarray, (x, g, w, b)), None if emb is None else jnp.asarray(emb),
        groups=groups, interpret=True)
    t = [None if a is None else torch.from_numpy(a) for a in (x, g, w, b, emb)]
    _close(_emulate(*t, groups), want)


@pytest.mark.parametrize("B,N,C,groups,with_emb", [(2, 700, 65, 65, False), (1, 600, 64, 32, True),
                                                   (1, 301, 128, 16, True)])
def test_emulated_kernel_matches_the_plain_version(B, N, C, groups, with_emb):
    """The UNet's 65 one-channel groups (no emb there), 2 channels a group
    (4-byte copies, the alignment net's 64 wide), and 8 a group over a
    cluster of 8 with a ragged last rank, at the same bar."""
    x, g, w, b, emb = (None if a is None else torch.from_numpy(a)
                       for a in _inputs(B, N, C, 90 + N, with_emb))
    _close(_emulate(x, g, w, b, emb, groups), groupnorm_silu_bwd_full_plain(x, g, w, b, emb,
                                                                          groups))
