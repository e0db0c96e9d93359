"""What the FFN forward kernel (``csrc/ffn.cu`` ``ffn_wgmma_kernel``) is
handed, on the CPU: the plan of ``ops/ffn.ffn_plan`` (token tiles, the
warpgroups' rows and columns, the cluster's split of the hidden chunks) covers
every (token, hidden unit) and every (token, channel) once, within the card's
shared memory and registers; and a torch emulation of the kernel's order of
arithmetic (bf16 LN rows, the hidden chunks of each rank, partials added in
rank order, bf16 gelu(h)) against the JAX package's Pallas kernel in
interpret mode, and with injected masks against ``ffn_dropout_plain``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.ops import pallas_ffn
from prediff_torch.ops import ffn, weights
from prediff_torch.ops.ffn import ffn_dropout_plain, ffn_plan, layer_norm_plain

# the FFN shapes of the kernels line (UNet B=1 and B=2 per stage, alignment
# net) and ragged token counts at each width
SHAPES = [(3328, 256), (832, 512), (6656, 256), (1664, 512), (1536, 128), (384, 256),
          (100, 128), (77, 256), (200, 512)]
# bf16 operands rounded at the same points on both sides: a 1-ulp f32
# difference before a rounding can flip one bf16 operand (2^-8 relative),
# which moves a few outputs by up to ~1e-2; the mean error stays ~1e-5
TOL_BF16, MEAN_TOL_BF16 = 1e-2, 1e-4
# the same roundings and masks on both sides, f32 sums in another order
TOL_SUM_ORDER = 1e-5


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_covers_every_unit_once(M, C):
    hidden = 4 * C
    plan = ffn_plan(M, C, hidden)
    hid_seen = np.zeros((M, hidden), dtype=np.int64)
    out_seen = np.zeros((M, C), dtype=np.int64)
    for t in range(plan.row_tiles):
        for wg in range(2):
            rows, h_cols, out_cols = plan.warpgroup_tile(wg)
            r = np.arange(t * plan.rows, (t + 1) * plan.rows)[list(rows)]
            r = r[r < M]
            for rank in range(plan.splits):
                for c in plan.chunk_range(rank):
                    j = c * 64 + np.array(list(h_cols))
                    hid_seen[np.ix_(r, j)] += 1
                # the epilogue: rank stores the 8-column groups jb % splits == rank
                cols = np.array(list(out_cols))
                mine = cols[((cols - cols[0]) // 8) % plan.splits == rank]
                out_seen[np.ix_(r, mine)] += 1
    assert (hid_seen == 1).all()
    assert (out_seen == 1).all()
    assert [c for rank in range(plan.splits) for c in plan.chunk_range(rank)] == \
        list(range(plan.chunks))


@pytest.mark.parametrize("M,C", SHAPES)
def test_plan_fits_the_card(M, C):
    plan = ffn_plan(M, C, 4 * C)
    assert plan.smem_bytes <= ffn.SMEM_LIMIT
    assert plan.partial_bytes <= ffn.STAGES * ffn.STAGE_BYTES   # parked in the ring
    # out and h accumulators, with room left for addresses and GELU under
    # the consumers' registers (setmaxnreg)
    assert plan.accumulators <= ffn.CONSUMER_REGISTERS - 72
    assert plan.splits in ffn.SPLITS and plan.splits <= plan.chunks
    assert plan.row_tiles * plan.splits <= ffn.SMS   # one wave
    # a ring item (W1c's columns or W2c's rows) fits a stage, and a chunk's
    # W2c items beside the next chunk's W1c items fit the ring
    assert 64 * plan.item_k * 2 <= ffn.STAGE_BYTES
    assert 2 * (C // plan.item_k) <= ffn.STAGES


def test_plan_at_the_unet_shapes():
    """About one wave at both stages: 26 x 4 and 13 x 8 blocks."""
    stage0, stage1 = ffn_plan(3328, 256, 1024), ffn_plan(832, 512, 2048)
    assert (stage0.rows, stage0.row_tiles, stage0.splits) == (128, 26, 4)
    assert (stage1.rows, stage1.row_tiles, stage1.splits) == (64, 13, 8)
    assert not stage0.split_cols and stage1.split_cols


@pytest.mark.parametrize("C,hidden", [(64, 256), (384, 1536), (256, 1000)])
def test_plan_refuses_what_the_wrapper_refused(C, hidden):
    with pytest.raises(ValueError, match="not supported"):
        ffn_plan(128, C, hidden)


def _emulate(x, ln_w, ln_b, w1, b1, w2, b2, eps, plan, masks=None, rates=(0.0, 0.0)):
    """The kernel's arithmetic: per token tile and rank, the rank's hidden
    chunks of 64 in order (h in f32 from the bf16 LN rows and W1 copy, gelu,
    m1, bf16), their products with the W2 copy summed in f32; the ranks'
    partials added in rank order, + b2, m2, + x."""
    M, C = x.shape
    ln = layer_norm_plain(x, ln_w, ln_b, eps).to(torch.bfloat16).float()
    w1b, w2b = weights.linear_bf16(w1).float(), weights.linear_bf16(w2).float()
    out = torch.empty_like(x)
    for t in range(plan.row_tiles):
        rows = slice(t * plan.rows, min(M, (t + 1) * plan.rows))
        total = None
        for rank in range(plan.splits):
            part = torch.zeros(rows.stop - rows.start, C)
            for c in plan.chunk_range(rank):
                j = slice(c * 64, (c + 1) * 64)
                a = torch.nn.functional.gelu(ln[rows] @ w1b[j].T + b1[j])
                if masks is not None and rates[0] > 0:
                    a = a * masks[0][rows, j] / (1.0 - rates[0])
                part = part + a.to(torch.bfloat16).float() @ w2b[:, j].T
            total = part if total is None else total + part
        y = total + b2
        if masks is not None and rates[1] > 0:
            y = y * masks[1][rows] / (1.0 - rates[1])
        out[rows] = x[rows] + y
    return out


def _inputs(M, C, hidden, seed):
    rs = np.random.RandomState(seed)
    x = (rs.randn(M, C) * 0.5).astype(np.float32)
    ln_s = (1.0 + 0.1 * rs.randn(C)).astype(np.float32)
    ln_b = (0.1 * rs.randn(C)).astype(np.float32)
    w1 = (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32)    # flax layout (in, out)
    b1 = (0.1 * rs.randn(hidden)).astype(np.float32)
    w2 = (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32)
    b2 = (0.1 * rs.randn(C)).astype(np.float32)
    return x, ln_s, ln_b, w1, b1, w2, b2


def _torch_args(x, ln_s, ln_b, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(x), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("M,C,hidden", [(200, 128, 512), (96, 512, 2048)])
def test_emulated_kernel_matches_the_interpret_kernel(M, C, hidden):
    args = _inputs(M, C, hidden, M + C)
    want = np.asarray(pallas_ffn.fused_ffn(*map(jnp.asarray, args), mxu_dtype_name="bfloat16",
                                           interpret=True))
    t = _torch_args(*args)
    got = _emulate(*t, 1e-5, ffn_plan(M, C, hidden)).numpy()
    err = np.abs(got.astype(np.float64) - want)
    assert err.max() <= TOL_BF16 * (1.0 + np.abs(want).max()), err.max()
    assert err.mean() <= MEAN_TOL_BF16, err.mean()


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_emulated_kernel_with_masks_matches_the_plain_dropout(rates):
    M, C, hidden = 150, 256, 1024
    t = _torch_args(*_inputs(M, C, hidden, 7))
    rs = np.random.RandomState(8)
    masks = (torch.from_numpy((rs.rand(M, hidden) >= rates[0]).astype(np.float32)),
             torch.from_numpy((rs.rand(M, C) >= rates[1]).astype(np.float32)))
    got = _emulate(*t, 1e-5, ffn_plan(M, C, hidden), masks, rates)
    want = ffn_dropout_plain(*t, 1e-5, *rates, masks=masks, mxu_dtype=torch.bfloat16)
    assert float((got - want).abs().max()) <= TOL_SUM_ORDER * float(want.abs().max())
