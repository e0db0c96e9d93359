"""Dropout in the training path (CPU, small shapes).

The port's masks are a pure function of (seed, site, tensor, element) from
Philox4x32-10 (``prediff_torch/ops/dropout.py``), which is held to the
published known-answer vectors.  The TPU kernels' masks come from the TPU's
own generator and cannot be reproduced, so what is held against the JAX
package is the *function given a mask*: the real bodies of
``fused_ffn_dropout`` / ``fused_ffn_dropout_bwd_full`` and of
``fused_axial_attention_5d(seed=)`` / ``fused_axial_attention_5d_bwd_full(seed=)``
run under ``pltpu.force_tpu_interpret_mode()`` with ``pallas_ffn._keep_mask``
and ``pallas_ffn.seed_prng`` patched to a hash of (grid cell, draw, row,
column) that numpy can repeat; the port's plain versions get the same masks
as tensors.  f32 operands on both sides, so only the order of the sums (and
exact erf against the TPU kernel's A&S 7.1.26, <= 4e-7) differs: forward
within 1e-5 of the output's scale, gradients within 1e-4.

Slice level, on configs/tiny_smoke.yaml with the recipe's rates 0.1: a train
step repeats bit for bit from one seed and differs between micro-steps, eval
mode is the rate-0 model, optimizer steps run and a checkpoint round-trips;
and one whole train-mode UNet forward against the flax UNet with the port's
masks injected into ``flax.linen.Dropout``.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.ops import pallas_attention, pallas_ffn
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import (build_alignment_model, build_pipeline, build_training_pipeline,
                                   build_unet)
from prediff_torch.models.init import init_params_
from prediff_torch.models.layers import TimeEmbedResBlock
from prediff_torch.ops import dropout
from prediff_torch.ops.attention import (axial_attention_bwd_full_plain, axial_attention_plain,
                                         axial_cuboid_size, fused_axial_attention)
from prediff_torch.ops.cuboid import cuboid_reorder
from prediff_torch.ops.ffn import (ffn_dropout_bwd_full_plain, ffn_dropout_plain, ffn_plain,
                                   fused_ffn)
from prediff_torch.training import DiffusionTrainer
from prediff_torch.training.diffusion_trainer import step_dropout_seed
from prediff_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
TOL_FWD = 1e-5     # of max(1, |want|): f32 both sides, another sum order
TOL_GRAD = 1e-4
RATES = dict(attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1)


# ---- the generator ----
# Known-answer vectors of Philox4x32-10 (Random123, kat_vectors): counter, key, output.
KAT = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
       ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
       ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
        (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    got = dropout.philox4x32(key, [torch.tensor([c], dtype=torch.int64) for c in counter])
    assert tuple(int(w) for w in got) == want


def test_keep_mask_is_a_function_of_seed_site_tensor_and_element():
    seed, shape, rate = 0x0123_4567_89AB_CDEF, (37, 101), 0.1   # 3737 elements: not 4 | n
    m = dropout.keep_mask(seed, 3, 1, shape, rate)
    assert m.dtype == torch.float32 and set(m.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(m, dropout.keep_mask(seed, 3, 1, shape, rate))
    # the draw of element e does not depend on the tensor's shape or size
    assert torch.equal(m.reshape(-1)[:999], dropout.keep_mask(seed, 3, 1, (999,), rate))
    # the key and counter words: (seed low, seed high), (e // 4 low, e // 4 high, tensor, site)
    bits = dropout.random_bits(seed, 3, 1, 8)
    words = dropout.philox4x32((0x89AB_CDEF, 0x0123_4567),
                               [torch.tensor([1]), torch.tensor([0]), torch.tensor([1]),
                                torch.tensor([3])])
    assert [int(b) for b in bits[4:]] == [int(w) for w in words]
    # the threshold rule of the TPU kernels: keep when bits >= round(rate * 2**32)
    assert dropout.threshold(0.1) == int(round(0.1 * 2.0 ** 32)) and dropout.threshold(0.0) == 0
    assert dropout.threshold(1.0) == 2 ** 32 - 1
    assert torch.equal(m.reshape(-1)[:8], (bits >= dropout.threshold(rate)).float())
    assert dropout.keep_mask(seed, 3, 1, shape, 0.0).all()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_mask_share_and_independence(rate):
    n = 200_000
    sigma = (rate * (1 - rate) / n) ** 0.5
    base = dropout.keep_mask(7, 0, 0, (n,), rate)
    assert abs(float(base.mean()) - (1 - rate)) <= 4 * sigma
    others = {"site": dropout.keep_mask(7, 1, 0, (n,), rate),
              "tensor": dropout.keep_mask(7, 0, 1, (n,), rate),
              "seed low word": dropout.keep_mask(8, 0, 0, (n,), rate),
              "seed high word": dropout.keep_mask(7 + 2 ** 32, 0, 0, (n,), rate)}
    for what, m in others.items():
        assert abs(float(m.mean()) - (1 - rate)) <= 4 * sigma, what
        # independent masks agree on keep^2 + drop^2 of the elements
        agree, want = float((m == base).float().mean()), (1 - rate) ** 2 + rate ** 2
        assert abs(agree - want) <= 4 * (want * (1 - want) / n) ** 0.5, what


# ---- the JAX kernel bodies with a mask numpy can repeat ----
def _hash_u32(*words):
    """An integer hash of uint32 words in wrapping arithmetic, for numpy or jnp."""
    h = words[0] * np.uint32(0x9E3779B1)
    for w in words[1:]:
        h = (h ^ w) * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _thr(rate):
    return np.uint32(min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1))


def hash_mask(cell, draw, row, col, rate):
    """The patched kernels' keep mask at (grid cell, draw, row, column), numpy side."""
    with np.errstate(over="ignore"):
        bits = _hash_u32(*np.broadcast_arrays(*(np.asarray(a, np.uint32)
                                                for a in (row, col, draw, cell))))
    return (bits >= _thr(rate)).astype(np.float32)


@pytest.fixture
def jax_masks(monkeypatch):
    """Patch the TPU generator out of the JAX dropout kernels: ``seed_prng``
    records the grid cell, ``_keep_mask`` hashes (row, column, draw, cell),
    draws counted in trace order.  ``pallas_attention`` delegates to
    ``pallas_ffn`` at call time, so the two patches reach both."""
    state = {}

    def seed_prng(seed_ref, idx):
        state["cell"], state["draw"] = idx, 0

    def keep_mask(shape, rate):
        draw, state["draw"] = state["draw"], state["draw"] + 1

        def full(v):
            return jnp.zeros(shape, jnp.uint32) + jnp.asarray(v).astype(jnp.uint32)

        bits = _hash_u32(jax.lax.broadcasted_iota(jnp.uint32, shape, 0),
                         jax.lax.broadcasted_iota(jnp.uint32, shape, 1), full(draw),
                         full(state["cell"]))
        return (bits >= _thr(rate)).astype(jnp.float32)

    monkeypatch.setattr(pallas_ffn, "seed_prng", seed_prng)
    monkeypatch.setattr(pallas_ffn, "_keep_mask", keep_mask)
    return jnp.zeros((2,), jnp.uint32)      # the seed words, unused by the patched draws


def _close(name, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol * scale, (name, np.abs(got - want).max(), scale)


def _ffn_inputs(tokens, C, hidden, seed):
    rs = np.random.RandomState(seed)
    return ((rs.randn(tokens, C) * 0.5).astype(np.float32),
            rs.randn(tokens, C).astype(np.float32),                     # cotangent
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, hidden) / np.sqrt(C)).astype(np.float32),       # flax layout (in, out)
            (0.1 * rs.randn(hidden)).astype(np.float32),
            (rs.randn(hidden, C) / np.sqrt(hidden)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32))


def _ffn_torch(x, g, ln_s, ln_b, w1, b1, w2, b2):
    t = torch.from_numpy
    return (t(x), t(g), t(ln_s), t(ln_b), t(np.ascontiguousarray(w1.T)), t(b1),
            t(np.ascontiguousarray(w2.T)), t(b2))


@pytest.mark.parametrize("rates", [(0.1, 0.1), (0.3, 0.0), (0.0, 0.2)])
def test_ffn_dropout_matches_the_jax_kernel_bodies(jax_masks, rates):
    tokens, C, hidden = 384, 128, 512                  # tile 128: three grid cells
    rate_act, rate_out = rates
    x, g, ln_s, ln_b, w1, b1, w2, b2 = _ffn_inputs(tokens, C, hidden, 0)
    kw = dict(rate_act=rate_act, rate_out=rate_out, mxu_dtype_name="float32")
    with pltpu.force_tpu_interpret_mode():
        want = pallas_ffn.fused_ffn_dropout(jnp.asarray(x), jax_masks, ln_s, ln_b, w1, b1, w2, b2,
                                            **kw)
        want_grads = pallas_ffn.fused_ffn_dropout_bwd_full(jnp.asarray(x), jnp.asarray(g),
                                                           jax_masks, ln_s, ln_b, w1, b1, w2, **kw)
    tm = pallas_ffn.pick_token_tile(tokens, hidden, max_bytes=pallas_ffn.FULL_BWD_TILE_BYTES)
    assert tokens // tm > 1
    rows = np.arange(tokens)[:, None]
    # draw order in a cell: the hidden mask, then the output mask (only the rates above 0 draw)
    m1 = hash_mask(rows // tm, 0, rows % tm, np.arange(hidden)[None], rate_act)
    m2 = hash_mask(rows // tm, 1 if rate_act > 0 else 0, rows % tm, np.arange(C)[None], rate_out)
    masks = (torch.from_numpy(m1), torch.from_numpy(m2))
    tx, tg, *params = _ffn_torch(x, g, ln_s, ln_b, w1, b1, w2, b2)
    got = ffn_dropout_plain(tx, *params, 1e-5, rate_act, rate_out, masks=masks)
    _close("out", got.numpy(), want, TOL_FWD)
    if rate_out > 0:          # the residual is never masked: out == x where m2 dropped
        assert np.array_equal(got.numpy()[m2 == 0], x[m2 == 0])
    grads = ffn_dropout_bwd_full_plain(tx, tg, *params[:-1], 1e-5, rate_act, rate_out, masks=masks)
    dx, dg, db, dw1, db1, dw2, db2 = (a.numpy() for a in grads)
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, (dx, dg, db, dw1.T, db1, dw2.T, db2), want_grads):
        _close(name, a, b, TOL_GRAD)


def _cells_and_rows(shape, axis, heads):
    """For every token of the natural layout, the linear grid cell of the JAX
    axial kernels that holds it and its row in that cell's block, from the
    kernels' own plan."""
    B, T, H, W, C = shape
    plan = pallas_attention.axial_attention_plan(shape, axis, num_heads=heads)
    tok = np.arange(B * T * H * W).reshape((B, T * H, W) if axis == 2 else (B, T, H, W))
    block = plan["block"][:-1]
    cell_of, row_of = np.empty(tok.size, np.int64), np.empty(tok.size, np.int64)
    grid = (B,) + tuple(plan["grid_tail"])
    for cell, gidx in enumerate(np.ndindex(*grid)):       # row-major, as _linear_cell_index
        bidx = plan["index_map"](*gidx)[:-1]
        toks = tok[tuple(slice(i * s, (i + 1) * s) for i, s in zip(bidx, block))].reshape(-1)
        cell_of[toks], row_of[toks] = cell, np.arange(toks.size)
    return cell_of, row_of, len(list(np.ndindex(*grid)))


def _attn_inputs(shape, axis, heads, seed):
    B, T, H, W, C = shape
    vol = (T, H, W)[axis]
    rs = np.random.RandomState(seed)
    return ((rs.randn(*shape) * 0.5).astype(np.float32), rs.randn(*shape).astype(np.float32),
            (1.0 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            (rs.randn(C, 3 * C) / np.sqrt(C)).astype(np.float32),
            (0.5 * rs.randn(heads, vol, vol)).astype(np.float32),
            (rs.randn(C, C) / np.sqrt(C)).astype(np.float32),
            (0.1 * rs.randn(C)).astype(np.float32))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_dropout_matches_the_jax_kernel_bodies(jax_masks, axis):
    shape, heads = (2, 4, 8, 16, 64), 2
    B, T, H, W, C = shape
    rate_attn, rate_proj = 0.1, 0.2
    x, g, ln_s, ln_b, wqkv, bias, wproj, bproj = _attn_inputs(shape, axis, heads, 3 + axis)
    scale = (C // heads) ** -0.5
    kw = dict(mxu_dtype_name="float32", seed=jax_masks, rate_attn=rate_attn, rate_proj=rate_proj)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_attention.fused_axial_attention_5d(
            jnp.asarray(x), axis, ln_s, ln_b, wqkv, bias, wproj, bproj, heads, scale, **kw)
        want_grads = pallas_attention.fused_axial_attention_5d_bwd_full(
            jnp.asarray(x), jnp.asarray(g), axis, ln_s, ln_b, wqkv, bias, wproj, heads, scale, **kw)
    # the port's masks in its own coordinates: (B, cuboids, heads, i, j) and natural (B,T,H,W,C)
    cell_of, row_of, n_cells = _cells_and_rows(shape, axis, heads)
    assert n_cells > B                                   # several cells per sample
    tok_r = cuboid_reorder(torch.arange(B * T * H * W).reshape(B, T, H, W, 1),
                           axial_cuboid_size(shape, axis), ("l", "l", "l"))[..., 0].numpy()
    cell_r, row_r = cell_of[tok_r], row_of[tok_r]         # (B, cuboids, vol)
    assert (cell_r == cell_r[..., :1]).all()              # a cuboid lies in one cell
    # draw order in a cell: one (R, R) mask per head, then the (R, C) output mask
    m_a = hash_mask(cell_r[:, :, None, :1, None], np.arange(heads)[None, None, :, None, None],
                    row_r[:, :, None, :, None], row_r[:, :, None, None, :], rate_attn)
    m_p = hash_mask(cell_of[:, None], heads, row_of[:, None], np.arange(C)[None],
                    rate_proj).reshape(shape)
    masks = (torch.from_numpy(m_a), torch.from_numpy(m_p))
    t = torch.from_numpy
    params = (t(ln_s), t(ln_b), t(np.ascontiguousarray(wqkv.T)), t(bias),
              t(np.ascontiguousarray(wproj.T)))
    got = axial_attention_plain(t(x), axis, *params, t(bproj), heads, scale, rate_attn=rate_attn,
                                rate_proj=rate_proj, masks=masks)
    _close("out", got.numpy(), want, TOL_FWD)
    assert np.array_equal(got.numpy() == 0, m_p == 0)     # the output mask, on the natural layout
    grads = axial_attention_bwd_full_plain(t(x), t(g), axis, *params, heads, scale,
                                           rate_attn=rate_attn, rate_proj=rate_proj, masks=masks)
    dx, dg, db, dwqkv, dbias, dwproj, dbproj = (a.numpy() for a in grads)
    names = ("dx", "dgamma", "dbeta", "dwqkv", "dbias", "dwproj", "dbproj")
    for name, a, b in zip(names, (dx, dg, db, dwqkv.T, dbias, dwproj.T, dbproj), want_grads):
        _close(name, a, b, TOL_GRAD)


# ---- the port's own contracts ----
def _torch_ffn_args(seed=0, tokens=96, C=64, hidden=256):
    x, g, *params = _ffn_torch(*_ffn_inputs(tokens, C, hidden, seed))
    return x, g, params


def _torch_attn_args(axis, seed=0, shape=(2, 3, 4, 5, 32), heads=2):
    x, g, ln_s, ln_b, wqkv, bias, wproj, bproj = _attn_inputs(shape, axis, heads, seed)
    t = torch.from_numpy
    return t(x), t(g), [t(ln_s), t(ln_b), t(np.ascontiguousarray(wqkv.T)), t(bias),
                        t(np.ascontiguousarray(wproj.T)), t(bproj)], heads


def test_ffn_rate_0_with_a_seed_is_the_function_without_dropout():
    x, g, params = _torch_ffn_args()
    assert torch.equal(ffn_dropout_plain(x, *params, 1e-5, 0.0, 0.0, seed=5, site=2),
                       ffn_plain(x, *params))
    assert torch.equal(fused_ffn(x, *params, 1e-5, 0.0, 0.0, seed=5, site=2),
                       fused_ffn(x, *params))
    with pytest.raises(ValueError, match="seed"):
        fused_ffn(x, *params, 1e-5, 0.1, 0.0)
    with pytest.raises(ValueError, match="seed"):
        ffn_dropout_plain(x, *params, 1e-5, 0.1, 0.0)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_rate_0_with_a_seed_is_the_function_without_dropout(axis):
    x, g, params, heads = _torch_attn_args(axis)
    plain = axial_attention_plain(x, axis, *params, heads, 0.25)
    assert torch.equal(axial_attention_plain(x, axis, *params, heads, 0.25, seed=5, site=2), plain)
    assert torch.equal(fused_axial_attention(x, axis, *params, heads, 0.25, seed=5, site=2), plain)
    with pytest.raises(ValueError, match="seed"):
        fused_axial_attention(x, axis, *params, heads, 0.25, 1e-5, 0.1)


def test_ffn_forward_and_backward_see_one_mask():
    """The Function's backward (the all-gradients plain version, which
    regenerates the masks from (seed, site)) equals autograd through the
    plain forward with the same masks; another site gives other masks."""
    x, g, params = _torch_ffn_args()
    leaves = [p.clone().requires_grad_(True) for p in [x] + params]
    out = fused_ffn(*leaves, 1e-5, 0.1, 0.2, seed=11, site=4)
    assert torch.equal(out, ffn_dropout_plain(x, *params, 1e-5, 0.1, 0.2, seed=11, site=4))
    assert not torch.equal(out, ffn_dropout_plain(x, *params, 1e-5, 0.1, 0.2, seed=11, site=5))
    got = torch.autograd.grad(out, leaves, g)
    ref = [p.clone().requires_grad_(True) for p in [x] + params]
    want = torch.autograd.grad(ffn_dropout_plain(*ref, 1e-5, 0.1, 0.2, seed=11, site=4), ref, g)
    for a, b in zip(got, want):
        _close("grad", a.numpy(), b.numpy(), TOL_GRAD)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_attention_forward_and_backward_see_one_mask(axis):
    x, g, params, heads = _torch_attn_args(axis)
    kw = dict(rate_attn=0.1, rate_proj=0.2, seed=11, site=4)
    leaves = [p.clone().requires_grad_(True) for p in [x] + params]
    out = fused_axial_attention(leaves[0], axis, *leaves[1:], heads, 0.25, 1e-5, **kw)
    assert torch.equal(out, axial_attention_plain(x, axis, *params, heads, 0.25, **kw))
    got = torch.autograd.grad(out, leaves, g)
    ref = [p.clone().requires_grad_(True) for p in [x] + params]
    want = torch.autograd.grad(axial_attention_plain(ref[0], axis, *ref[1:], heads, 0.25, **kw),
                               ref, g)
    for a, b in zip(got, want):
        _close("grad", a.numpy(), b.numpy(), TOL_GRAD)


# ---- the slice: training configs/tiny_smoke.yaml at the recipe's rates ----
def _tiny_cfg(**rates):
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(RATES if not rates else rates)
    return cfg


def _tiny_trainer(cfg, seed=3):
    ld = build_training_pipeline(cfg, device="cpu", seed=seed)
    init_params_(ld.unet, torch.Generator().manual_seed(seed), randomize=True)
    return ld, DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=8, accum_steps=2))


def _tiny_batch(cfg, seed=0):
    L = cfg.layout
    rs = np.random.RandomState(seed)
    b = torch.from_numpy(rs.rand(2, L.in_len + L.out_len, L.img_height, L.img_width,
                                 1).astype(np.float32))
    return b[:, L.in_len:], b[:, :L.in_len]


def _draws(ld, seed=1):
    rs = torch.Generator().manual_seed(seed)
    z = torch.randn((2,) + ld.latent_shape, generator=rs)
    zc = torch.randn((2,) + ld.cond_latent_shape, generator=rs)
    return z, zc, torch.tensor([1, 6]), torch.randn(z.shape, generator=rs)


def test_train_step_repeats_from_one_seed_and_differs_between_micro_steps():
    cfg = _tiny_cfg()
    x, y = _tiny_batch(cfg)
    runs = []
    for _ in range(2):
        ld, trainer = _tiny_trainer(cfg)
        state = trainer.create_state()
        losses = []
        for _ in range(2):                    # the two micro-steps of one optimizer step
            state, out = trainer.train_step(state, 5, x, y)
            losses.append(float(out["train/loss"]))
        runs.append((losses, [p.detach().clone() for p in state.params.values()]))
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0]).all()
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    # state.step counts micro-steps, so the two micro-steps of one optimizer step draw other masks
    s0, s1 = step_dropout_seed(5, 0), step_dropout_seed(5, 1)
    assert s0 != s1 and s0 == step_dropout_seed(torch.Generator().manual_seed(5), 0)
    assert step_dropout_seed(6, 0) != s0 and 0 <= s0 < 2 ** 64
    lv = ld.init_logvar()
    with torch.no_grad():                     # the same z, t and noise: only the masks differ
        a = float(ld.p_losses(lv, *_draws(ld), dropout_seed=s0)[0])
        assert a == float(ld.p_losses(lv, *_draws(ld), dropout_seed=s0)[0])
        assert a != float(ld.p_losses(lv, *_draws(ld), dropout_seed=s1)[0])
        with pytest.raises(ValueError, match="dropout_seed"):
            ld.p_losses(lv, *_draws(ld))


def test_eval_mode_is_the_rate_0_model():
    cfg = _tiny_cfg()
    ld, trainer = _tiny_trainer(cfg)
    ld0 = build_training_pipeline(_tiny_cfg(attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0),
                                  device="cpu", params={"unet": ld.unet.state_dict(),
                                                        "vae": ld.vae.state_dict()})
    z, zc, t, _ = _draws(ld)
    with torch.no_grad():
        want = ld0.unet(z, t, zc)             # training mode, every rate 0
        assert torch.equal(ld.unet.eval()(z, t, zc), want)
        assert not torch.equal(ld.unet.train()(z, t, zc, dropout_seed=1), want)
    state = trainer.create_state()
    x, y = _tiny_batch(cfg)
    val = trainer.val_step(state, 2, x, y)    # eval mode: no seed asked for, no dropout
    val0 = DiffusionTrainer(ld0).val_step(DiffusionTrainer(ld0).create_state(), 2, x, y)
    assert float(val["val/loss"]) == float(val0["val/loss"]) and ld.unet.training
    served = build_pipeline(cfg, device="cpu")
    assert not served.unet.training          # serving is untouched: frozen, eval mode


def test_optimizer_steps_and_checkpoint_round_trip_with_dropout(tmp_path):
    cfg = _tiny_cfg()
    ld, trainer = _tiny_trainer(cfg)
    state = trainer.create_state()
    before = {k: p.detach().clone() for k, p in state.params.items()}
    x, y = _tiny_batch(cfg)
    for _ in range(5):
        state, out = trainer.train_step(state, 0, x, y)
        assert np.isfinite(float(out["train/loss"])) and np.isfinite(float(out["grad_norm"]))
    assert state.step == 5 and state.tx.count == 2
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
    save_checkpoint(str(tmp_path / "ckpt"), state)       # in the middle of an accumulation
    _, trainer2 = _tiny_trainer(cfg)      # the same frozen VAE; the UNet comes from the checkpoint
    for p in trainer2.ld.unet.parameters():
        p.data.zero_()
    fresh = trainer2.create_state()
    restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    state, a = trainer.train_step(state, 0, x, y)          # the third optimizer step
    fresh, b = trainer2.train_step(fresh, 0, x, y)
    assert state.tx.count == fresh.tx.count == 3
    assert float(a["train/loss"]) == float(b["train/loss"])   # the restored run draws the same
    assert all(torch.equal(fresh.params[k], state.params[k]) for k in state.params)


def test_alignment_net_refuses_to_train_with_dropout():
    """The alignment net trains with dropout only from a step's seed: the
    shared blocks carry the configuration's rates, eval mode (guidance)
    ignores them, training mode without ``dropout_seed`` raises and with one
    draws its masks; the fused resblock refuses an active dropout."""
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.align.model_args.update(RATES)
    net = build_alignment_model(cfg)
    assert net.dropout_rates["attn_drop"] == 0.1
    assert net.down_self_blocks[0][0].attn_l[0].attn_drop == 0.1
    assert net.down_self_blocks[0][0].ffn_l[0].dropout == 0.1 and net.first_proj.dropout == 0.1
    zt, t = torch.zeros((1,) + tuple(cfg.model.align.model_args.input_shape)), torch.tensor([3])
    with pytest.raises(ValueError, match="dropout_seed"):
        net.train()(zt, t)
    with torch.no_grad():
        dropped = net.train()(zt, t, dropout_seed=5)
        assert torch.isfinite(dropped).all()
        assert torch.isfinite(net.eval()(zt, t)).all()
        assert not torch.equal(dropped, net(zt, t))
    cfg.model.align.model_args.update(attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0)
    with torch.no_grad():
        assert torch.isfinite(build_alignment_model(cfg).train()(zt, t)).all()   # rates 0: runs
    block = TimeEmbedResBlock(128, 128, emb_channels=16, fused=True, dropout=0.1).train()
    stream = dropout.DropoutStream(1)
    with pytest.raises(NotImplementedError, match="fused"):
        block(torch.zeros(1, 2, 4, 4, 128), torch.zeros(1, 16), stream)
    with pytest.raises(ValueError, match="DropoutStream"):
        TimeEmbedResBlock(8, 8, emb_channels=16, dropout=0.1).train()(
            torch.zeros(1, 2, 4, 4, 8), torch.zeros(1, 16))


# ---- one whole train-mode forward against the flax UNet, the port's masks injected ----
def test_train_mode_unet_forward_matches_flax_with_injected_masks(monkeypatch):
    """Every ``flax.linen.Dropout`` call of the flax UNet's train-mode forward
    (its XLA path: on the CPU the flax modules leave their kernels when
    dropout is active) takes the mask the port drew at the same site, in call
    order.  The port's masks index logical coordinates: the attention-weight
    mask (B, cuboids, heads, i, j) is flax's own layout, the FFN masks
    (tokens, width) reshape to (B, T, H, W, width), and the attention output
    mask, natural (B, T, H, W, C) in the port, is reordered into cuboids,
    where flax applies its dropout."""
    # T, H, W differ at both stages (5, 4, 6 and 5, 2, 3), so a cuboid shape names its axis
    over = dict(input_shape=[3, 4, 6, 8], target_shape=[2, 4, 6, 8], base_units=16, num_heads=2,
                depth=[1, 1], time_embed_dropout=0.1, **RATES)
    jcfg = jax_load_config(jax_default_config)
    jcfg.model.latent_model.update(over)
    tcfg = load_config(prediff_default_config)
    tcfg.model.latent_model.update(over)
    junet = jax_build_unet(jcfg)
    rs = np.random.RandomState(0)
    x, cond = rs.randn(2, 2, 4, 6, 8).astype(np.float32), rs.randn(2, 3, 4, 6, 8).astype(np.float32)
    t = np.array([3, 777], np.int32)
    params = randomize_flax(junet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(cond))["params"], seed=1)
    tunet = build_unet(tcfg).train()
    tunet.load_state_dict(flax_params_to_torch(tunet, params))

    drawn = []                                # (shape, rate, mask) of the port's draws, in order
    real_keep_mask = dropout.keep_mask

    def recording(seed, site, tensor, shape, rate, device=None):
        mask = real_keep_mask(seed, site, tensor, shape, rate, device)
        drawn.append((tuple(shape), rate, mask.numpy()))
        return mask

    monkeypatch.setattr(dropout, "keep_mask", recording)
    import prediff_torch.models.layers as tlayers
    monkeypatch.setattr(tlayers, "keep_mask", recording)
    with torch.no_grad():
        got = tunet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond),
                    dropout_seed=21).numpy()
        assert not np.array_equal(got, tunet.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                                                    torch.from_numpy(cond)).numpy())
    # first_proj, then per stage and direction: the time block, and 3 x (attention 2, FFN 2)
    assert len(drawn) == 1 + 4 * (1 + 3 * 4)
    pending = list(drawn)

    def injected(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        shape, rate, mask = pending.pop(0)
        assert rate == self.rate
        if mask.size != inputs.size:
            raise AssertionError(f"site order differs: flax drops {inputs.shape}, the port {shape}")
        if mask.ndim == 5 and inputs.ndim == 4:      # the attention output: natural -> cuboids
            B, nC, vol, C = inputs.shape
            T, H, W = shape[1:4]
            (axis,) = [a for a in range(3) if (T, H, W)[a] == vol]
            mask = cuboid_reorder(torch.from_numpy(mask), axial_cuboid_size(shape, axis),
                                  ("l", "l", "l")).numpy()
        return inputs * jnp.asarray(mask.reshape(inputs.shape)) / (1.0 - self.rate)

    monkeypatch.setattr(fnn.Dropout, "__call__", injected)
    want = np.asarray(junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond), deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(0)}))
    assert not pending
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
