"""What the FFN all-gradients backward (``csrc/ffn.cu`` ``ffn_bwd_kernel``)
and the weight-gradient product it shares (``csrc/grad_common.cuh``
``wgrad_kernel``) are handed, on the CPU: the plans of ``ops/ffn.ffn_bwd_plan``
and ``ops/wgrad.wgrad_plan`` cover every (token, hidden unit), every (token,
channel) and every weight-gradient element once, within the card's shared
memory and registers, and admit every shape the first design took; a torch
emulation of the kernels' order of arithmetic (bf16 LN(x), do, dh and a at
the TPU kernel's points, each rank's hidden chunks, the ranks' dln partials
added in rank order, the token slices of the weight gradients added in rank
order) against the JAX package's Pallas kernel in interpret mode and, with
injected masks, against ``ffn_dropout_bwd_full_plain``; and the whole-block
Philox draws of the kernels (a lane pair's swapped halves, 8 and 4 channels
a thread) against ``ops/dropout.py``'s masks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_ffn
from prediff_torch.ops import dropout, ffn, weights, wgrad
from prediff_torch.ops.ffn import (ffn_bwd_plan, ffn_dropout_bwd_full_plain, gelu_grad,
                                   layer_norm_bwd_plain, layer_norm_plain)

# the training shapes (B=2 per stage), the alignment net's, ragged token counts
SHAPES = [(6656, 256), (1664, 512), (3328, 256), (832, 512), (1536, 128), (384, 256),
          (100, 128), (77, 256), (200, 512)]
# the bars of tests/test_torch_bwd_full.py (bf16 operands at the same points)
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4
# the same roundings and masks on both sides, f32 sums in another order
TOL_SUM_ORDER = 1e-5
FFN_NAMES = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_covers_every_unit_once(M, C):
    hidden = 4 * C
    plan = ffn_bwd_plan(M, C, hidden)
    hid_seen = np.zeros((M, hidden), dtype=np.int64)
    dln_seen = np.zeros((plan.splits, M, C), dtype=np.int64)   # each rank's partial
    dx_seen = np.zeros((M, C), dtype=np.int64)
    for t in range(plan.row_tiles):
        rows = np.arange(t * ffn.BWD_ROWS, (t + 1) * ffn.BWD_ROWS)
        for rank in range(plan.splits):
            for wg in range(2):
                h_cols, dln_cols = plan.warpgroup_tile(wg)
                r = rows[rows < M]
                for c in plan.chunk_range(rank):
                    hid_seen[np.ix_(r, c * 64 + np.array(list(h_cols)))] += 1
                dln_seen[rank][np.ix_(r, np.array(list(dln_cols)))] += 1
            mine = rows[list(plan.rank_rows(rank))]
            dx_seen[mine[mine < M]] += 1
    assert (hid_seen == 1).all()
    assert (dln_seen == 1).all()
    assert (dx_seen == 1).all()
    assert [c for r in range(plan.splits) for c in plan.chunk_range(r)] == list(range(plan.chunks))


@pytest.mark.parametrize("P,Q,M", [(1024, 256, 6656), (512, 2048, 1664), (768, 256, 6656),
                                   (64, 64, 100), (3 * 64, 64, 7), (2048, 512, 1664)])
def test_weight_gradient_plan_covers_every_element_once(P, Q, M):
    plan = wgrad.wgrad_plan(P, Q, M)
    seen = np.zeros((P, Q), dtype=np.int64)
    tp, tq = plan.tiles
    for i in range(tp):
        for j in range(tq):
            rows, cols = plan.tile(i, j)
            for rank in range(plan.splits):
                for jb in plan.rank_groups(rank):
                    c = np.array([q for q in range(8 * jb, 8 * jb + 8)]) + j * wgrad.TILE
                    c = c[c < Q]
                    seen[np.ix_(np.array(list(rows)), c)] += 1
    assert (seen == 1).all()
    slices = [s for r in range(plan.splits) for s in plan.slice_range(r)]
    assert slices == list(range(plan.slices)) and all(plan.slice_range(r) for r in
                                                      range(plan.splits))
    assert plan.splits in wgrad.SPLITS and tp * tq * plan.splits <= max(wgrad.SMS, tp * tq)
    assert plan.smem_bytes <= ffn.SMEM_LIMIT and plan.partial_bytes <= wgrad.STAGES * wgrad.STAGE_BYTES


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_fits_the_card(M, C):
    plan = ffn_bwd_plan(M, C, 4 * C)
    # dynamic shared memory beside the static barriers and column sums
    assert plan.smem_bytes + 2048 <= ffn.SMEM_LIMIT
    assert plan.epilogue_bytes <= plan.smem_bytes - 1024
    assert plan.accumulators <= ffn.CONSUMER_REGISTERS - 72
    assert plan.splits in ffn.SPLITS and plan.splits <= plan.chunks
    assert plan.row_tiles * plan.splits <= max(ffn.SMS, plan.row_tiles)
    assert 64 * plan.item_k * 2 <= ffn.STAGE_BYTES
    assert ffn.BWD_ROWS % plan.splits == 0 and ffn.BWD_ROWS // plan.splits >= 8  # a row a warp


def test_plans_admit_every_shape_the_first_design_took():
    """C in (128, 256, 512) with hidden a multiple of 64, any token count."""
    for C in (128, 256, 512):
        for hidden in (64, 128, 448, 4 * C):
            for M in (1, 63, 64, 65, 1000):
                assert ffn.supports_shape(M, C, hidden)
                plan = ffn_bwd_plan(M, C, hidden)
                assert plan.splits <= hidden // 64
    for C, hidden in ((64, 256), (96, 384), (640, 2560), (256, 1000)):
        assert not ffn.supports_shape(100, C, hidden)
        with pytest.raises(ValueError, match="not supported"):
            ffn_bwd_plan(100, C, hidden)


def _bf(t):
    return t.to(torch.bfloat16).float()


def _wgrad(a_t, b_t, M):
    """dW = A^T . B as wgrad_kernel adds it: per rank its 64-token slices in
    order, the ranks' partials in rank order (a_t, b_t width-major)."""
    plan = wgrad.wgrad_plan(a_t.shape[0], b_t.shape[0], M)
    total = None
    for rank in range(plan.splits):
        part = torch.zeros(a_t.shape[0], b_t.shape[0])
        for s in plan.slice_range(rank):
            k = slice(64 * s, min(M, 64 * (s + 1)))
            part = part + a_t[:, k] @ b_t[:, k].T
        total = part if total is None else total + part
    return total


def _emulate(x, g, ln_w, ln_b, w1, b1, w2, eps, masks=None, rates=(0.0, 0.0)):
    """The backward's arithmetic: per 64-row tile and rank its hidden chunks
    (h from the bf16 LN rows and W1 copy, da from bf16 do and the W2^T copy,
    dh = da . gelu'(h) masked, rounded to bf16, dln += dh . W1), the ranks'
    partials added in rank order, the LayerNorm backward + g; the vector
    gradients' partials per (tile, rank) added in order; the weight
    gradients of ``_wgrad`` on the bf16 width-major side outputs."""
    M, C = x.shape
    hidden = w1.shape[0]
    plan = ffn_bwd_plan(M, C, hidden)
    ln = _bf(layer_norm_plain(x, ln_w, ln_b, eps))
    mu = x.mean(dim=-1, keepdim=True)
    nhat = (x - mu) * torch.rsqrt((x - mu).square().mean(dim=-1, keepdim=True) + eps)
    do = g if masks is None or rates[1] == 0 else g * masks[1] / (1.0 - rates[1])
    dob = _bf(do)
    w1b, w2t, w1t = (weights.linear_bf16(w1).float(), weights.linear_t_bf16(w2).float(),
                     weights.linear_t_bf16(w1).float())
    dx, a_all, dh_all = torch.empty_like(x), torch.empty(M, hidden), torch.empty(M, hidden)
    vparts, db1_parts = [], []
    for t in range(plan.row_tiles):
        rows = slice(t * 64, min(M, (t + 1) * 64))
        partials = []
        for rank in range(plan.splits):
            part = torch.zeros(rows.stop - rows.start, C)
            for c in plan.chunk_range(rank):
                j = slice(c * 64, (c + 1) * 64)
                h = ln[rows] @ w1b[j].T + b1[j]
                dh = (dob[rows] @ w2t[j].T) * gelu_grad(h)
                a = torch.nn.functional.gelu(h)
                if masks is not None and rates[0] > 0:
                    dh = dh * masks[0][rows, j] / (1.0 - rates[0])
                    a = a * masks[0][rows, j] / (1.0 - rates[0])
                a_all[rows, j], dh_all[rows, j] = a, dh
                part = part + _bf(dh) @ w1t[:, j].T
            partials.append(part)
        dln = partials[0]
        for p in partials[1:]:
            dln = dln + p
        dx[rows] = g[rows] + layer_norm_bwd_plain(x[rows], ln_w, dln, eps)
        for rank in range(plan.splits):
            r = [i for i in plan.rank_rows(rank) if t * 64 + i < M]
            d, n = dln[r], nhat[rows][r]
            vparts.append(torch.stack([(d * n).sum(0), d.sum(0),
                                       dob.new_zeros(C) if rank else do[rows].sum(0)]))
        db1_parts.append(dh_all[rows].sum(0))
    vec = vparts[0]
    for v in vparts[1:]:
        vec = vec + v
    db1 = db1_parts[0]
    for v in db1_parts[1:]:
        db1 = db1 + v
    dw1 = _wgrad(_bf(dh_all).T, ln.T, M)
    dw2 = _wgrad(dob.T, _bf(a_all).T, M)
    return dx, vec[0], vec[1], dw1, db1, dw2, vec[2]


def _inputs(M, C, hidden, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(M, C) * 0.5).astype(np.float32), rs.randn(M, C).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32),      # flax layout (in, out)
            (0.1 * rs.randn(hidden)).astype(np.float32),
            (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32))


def _torch_args(x, g, ln_s, ln_b, w1, b1, w2):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)))


@pytest.mark.parametrize("M,C,hidden", [(200, 128, 512), (96, 512, 2048)])
def test_emulated_backward_matches_the_interpret_kernel(M, C, hidden):
    args = _inputs(M, C, hidden, M + C)
    want = pallas_ffn.fused_ffn_bwd_full(*map(jnp.asarray, args), mxu_dtype_name="bfloat16",
                                         interpret=True)
    got = _emulate(*_torch_args(*args), 1e-5)
    flax = (got[0], got[1], got[2], got[3].T, got[4], got[5].T, got[6])   # flax weight layouts
    for name, a, b in zip(FFN_NAMES, flax, want):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        err, scale = np.abs(a - b), max(1.0, np.abs(b).max())
        assert err.max() <= TOL_BF16 * scale, (name, err.max(), scale)
        assert err.mean() <= MEAN_TOL_BF16 * scale, (name, err.mean(), scale)


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_emulated_backward_with_masks_matches_the_plain_dropout(rates):
    M, C, hidden = 150, 256, 1024
    t = _torch_args(*_inputs(M, C, hidden, 7))
    rs = np.random.RandomState(8)
    masks = (torch.from_numpy((rs.rand(M, hidden) >= rates[0]).astype(np.float32)),
             torch.from_numpy((rs.rand(M, C) >= rates[1]).astype(np.float32)))
    got = _emulate(*t, 1e-5, masks, rates)
    want = ffn_dropout_bwd_full_plain(*t, 1e-5, *rates, masks=masks, mxu_dtype=torch.bfloat16)
    for name, a, b in zip(FFN_NAMES, got, want):
        assert float((a - b).abs().max()) <= TOL_SUM_ORDER * float(b.abs().max()), name


# ---- the kernels' whole-block Philox draws against ops/dropout.py ----
SEED, SITE, RATE = 0x5EED_0F_D20905, 7, 0.1


def _block(seed, site, tensor, e):
    """philox.cuh block(): the four words of the block of element e."""
    q = torch.tensor([e // 4], dtype=torch.int64)
    zero = torch.zeros_like(q)
    return [int(w) for w in dropout.philox4x32(dropout.seed_words(seed),
                                               (q & 0xFFFFFFFF, q >> 32, zero + tensor,
                                                zero + site))]


def test_pair_draw_of_an_mma_fragment_gives_the_masks():
    """draw_rows2: lanes L (even) and L ^ 1 draw one block each (L row A's,
    L ^ 1 row B's) and swap halves; each lane's two draws in both rows are
    those of keep_mask at its elements."""
    hidden, rows, j0 = 256, 16, 64
    thr = dropout.threshold(RATE)
    want = dropout.keep_mask(SEED, SITE, 0, (rows, hidden), RATE)
    for jb in range(4):
        drawn = {}
        for lane in range(32):
            col = j0 + 8 * jb + 2 * (lane & 3)
            eA = (lane >> 2) * hidden + col
            eB = eA + 8 * hidden
            drawn[lane] = (_block(SEED, SITE, 0, eB if lane & 1 else eA), col)
        for lane in range(32):
            own, col = drawn[lane]
            odd = lane & 1
            # what the partner sends across the pair: the odd lane its (x, y), the even its (z, w)
            partner = drawn[lane ^ 1][0]
            sent = partner[2:4] if odd else partner[0:2]
            wa = tuple(sent) if odd else (own[0], own[1])
            wb = (own[2], own[3]) if odd else tuple(sent)
            rA = lane >> 2
            for e in range(2):
                assert (wa[e] >= thr) == bool(want[rA, col + e])
                assert (wb[e] >= thr) == bool(want[rA + 8, col + e])


def test_eight_and_four_column_draws_give_the_masks():
    """apply8 (the FFN's do: 8 channels, two whole blocks) and cast_t_kernel
    (4 channels, one block) against keep_mask of tensor 1."""
    M, C = 5, 64
    thr = dropout.threshold(RATE)
    want = dropout.keep_mask(SEED, SITE, 1, (M, C), RATE)
    for row in range(M):
        for c8 in range(0, C, 8):
            words = [w for b in range(2) for w in _block(SEED, SITE, 1, row * C + c8 + 4 * b)]
            assert [w >= thr for w in words] == [bool(v) for v in want[row, c8:c8 + 8]]
        for c4 in range(0, C, 4):
            words = _block(SEED, SITE, 1, row * C + c4)
            assert [w >= thr for w in words] == [bool(v) for v in want[row, c4:c4 + 4]]
