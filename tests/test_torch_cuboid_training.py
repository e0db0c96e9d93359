"""Training the non-axial cuboid patterns (CPU, small shapes).

The general layer's all-gradients backward and its dropout forms: the port's
plain versions against the JAX kernel bodies, ``fused_cuboid_attention_
layer_v4_bwd_full`` in interpret mode and the ``seed=`` forms of it and of
``fused_cuboid_attention_layer_v4`` under ``pltpu.force_tpu_interpret_mode()``
with the TPU generator patched out (the numpy hash of
``test_torch_dropout.py``); each training route of ``CuboidSelfAttentionLayer``
(``v4``, ``grouped_masked`` with output dropout, the einsum route under
attention dropout) against the flax layer with the port's masks injected into
``flax.linen.Dropout``; a tiny ``video_swin_2x2`` UNet in training mode at
rates 0 against ``jax.vjp`` of the flax UNet (the JAX layers take their CPU
route there: at 16 channels the v4 kernel's ``dim % 128`` gate keeps it out,
so the interpret-mode kernel body is held above, layer by layer), and its
trainer at the recipe's rates 0.1.  f32 on both sides: forwards within 1e-5
and gradients within 1e-4 of the output's scale, as in ``test_torch_dropout.py``.
"""
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from test_torch_attention import _torch_args
from test_torch_bwd_full import ATTN_NAMES, assert_close
from test_torch_cuboid_attention import _layer_inputs
from test_torch_dropout import TOL_FWD, TOL_GRAD, _close, hash_mask, jax_masks  # noqa: F401
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.models.cuboid_attention import CuboidSelfAttentionLayer as JaxLayer
from prediff_tpu.ops import pallas_attention
from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
from prediff_torch.factory import build_training_pipeline, build_unet
from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
from prediff_torch.models.init import init_params_
from prediff_torch.ops import attention, dropout
from prediff_torch.ops.attention import (cuboid_attention_bwd_full_plain,
                                         cuboid_attention_dropout_bwd_full_plain,
                                         cuboid_attention_dropout_plain)
from prediff_torch.training import DiffusionTrainer
from prediff_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
PATTERN = "video_swin_2x2"
RATES = dict(attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1)


def _to_flax(grads):
    dx, dg, db, dwqkv, dbias, dwproj, dbproj = (a.numpy() for a in grads)
    return dx, dg, db, dwqkv.T, dbias, dwproj.T, dbproj


# ---- the kernel bodies ----
# (B, cuboids, vol, C): G = 8 cuboids of vol 16 per TPU grid cell, G = 1 at vol 144
@pytest.mark.parametrize("shape,G", [((2, 8, 16, 64), 8), ((1, 2, 144, 128), 1)])
@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_bwd_full_plain_matches_interpret_kernel(shape, G, mxu):
    heads = 4
    x, ln_s, ln_b, wqkv, bias, wproj, bproj = _layer_inputs(shape, heads, 20)
    g = np.random.RandomState(21).randn(*shape).astype(np.float32)
    scale = (shape[3] // heads) ** -0.5
    assert pallas_attention.pick_cuboid_group(shape[1], shape[2], C=shape[3],
                                              num_heads=heads) == G
    want = pallas_attention.fused_cuboid_attention_layer_v4_bwd_full(
        jnp.asarray(x), jnp.asarray(g), *map(jnp.asarray, (ln_s, ln_b, wqkv, bias, wproj)),
        num_heads=heads, scale=scale, mxu_dtype_name=mxu, interpret=True)
    t = _torch_args(x, ln_s, ln_b, wqkv, bias, wproj, bproj)
    dtype = torch.bfloat16 if mxu == "bfloat16" else None
    got = _to_flax(cuboid_attention_bwd_full_plain(t[0], torch.from_numpy(g), *t[1:6], heads,
                                                   scale, mxu_dtype=dtype))
    for name, a, b in zip(ATTN_NAMES, got, want):
        assert_close(name, a, b, bf16=dtype is not None)


def _v4_masks(shape, heads, rate_attn, rate_proj):
    """The patched JAX kernels' masks in the port's coordinates: the port's
    (b, cuboid n, head h, i, j) is TPU grid cell (b, n // G), draw h, row
    (n % G) vol + i, column (n % G) vol + j; the output's (b, n, i, c) is draw
    ``heads`` (0 when the weights draw nothing), row (n % G) vol + i, column c."""
    B, nC, vol, C = shape
    G = pallas_attention.pick_cuboid_group(nC, vol, C=C, num_heads=heads)
    n, i = np.arange(nC), np.arange(vol)
    cell = np.arange(B)[:, None] * (nC // G) + n[None, :] // G         # (B, nC)
    row = ((n % G) * vol)[:, None] + i[None, :]                         # (nC, vol)
    m_a = hash_mask(cell[:, :, None, None, None], np.arange(heads)[None, None, :, None, None],
                    row[None, :, None, :, None], row[None, :, None, None, :], rate_attn)
    m_p = hash_mask(cell[:, :, None, None], heads if rate_attn > 0 else 0, row[None, :, :, None],
                    np.arange(C)[None, None, None, :], rate_proj)
    return G, torch.from_numpy(m_a), torch.from_numpy(m_p)


@pytest.mark.parametrize("shape,rates", [((2, 32, 16, 64), (0.1, 0.2)),
                                         ((1, 3, 144, 64), (0.1, 0.2)),
                                         ((2, 32, 16, 64), (0.3, 0.0)),
                                         ((2, 32, 16, 64), (0.0, 0.2))])
def test_dropout_forms_match_the_jax_kernel_bodies(jax_masks, shape, rates):  # noqa: F811
    heads = 2
    rate_attn, rate_proj = rates
    x, ln_s, ln_b, wqkv, bias, wproj, bproj = _layer_inputs(shape, heads, 22)
    g = np.random.RandomState(23).randn(*shape).astype(np.float32)
    scale = (shape[3] // heads) ** -0.5
    kw = dict(num_heads=heads, scale=scale, mxu_dtype_name="float32", seed=jax_masks,
              rate_attn=rate_attn, rate_proj=rate_proj)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_attention.fused_cuboid_attention_layer_v4(
            jnp.asarray(x), ln_s, ln_b, wqkv, bias, wproj, bproj, **kw)
        want_grads = pallas_attention.fused_cuboid_attention_layer_v4_bwd_full(
            jnp.asarray(x), jnp.asarray(g), ln_s, ln_b, wqkv, bias, wproj, **kw)
    G, m_a, m_p = _v4_masks(shape, heads, rate_attn, rate_proj)
    assert shape[0] * shape[1] // G > shape[0] or G == 1      # several cells per sample
    t = _torch_args(x, ln_s, ln_b, wqkv, bias, wproj, bproj)
    drop = dict(rate_attn=rate_attn, rate_proj=rate_proj, masks=(m_a, m_p))
    got = cuboid_attention_dropout_plain(*t, heads, scale, **drop)
    _close("out", got.numpy(), want, TOL_FWD)
    if rate_proj > 0:   # the output mask, on the reordered layout
        assert np.array_equal(got.numpy() == 0, m_p.numpy() == 0)
    grads = _to_flax(cuboid_attention_dropout_bwd_full_plain(t[0], torch.from_numpy(g), *t[1:6],
                                                             heads, scale, **drop))
    for name, a, b in zip(ATTN_NAMES, grads, want_grads):
        _close(name, a, b, TOL_GRAD)


# ---- each training route against the flax layer, the port's masks injected ----
# route, (T, H, W), cuboid, shift, strategy, padding type, attn_drop, proj_drop
ROUTE_CASES = [
    ("v4", (5, 6, 6), (1, 2, 2), (0, 0, 0), ("d", "d", "d"), "zeros", 0.1, 0.1),
    ("grouped_masked", (5, 6, 6), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "zeros", 0.0, 0.1),
    ("grouped_einsum", (5, 6, 6), (2, 4, 4), (1, 2, 2), ("l", "l", "l"), "zeros", 0.1, 0.1),
    ("grouped_einsum", (5, 6, 6), (2, 4, 4), (0, 0, 0), ("l", "l", "l"), "ignore", 0.1, 0.0),
]


def _inject(monkeypatch, pending):
    """Every active ``flax.linen.Dropout`` call takes the next of ``pending``
    (shape, rate, mask), in call order."""

    def injected(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        shape, rate, mask = pending.pop(0)
        assert rate == self.rate and mask.size == inputs.size, (shape, inputs.shape)
        return inputs * jnp.asarray(mask.reshape(inputs.shape)) / (1.0 - self.rate)

    monkeypatch.setattr(fnn.Dropout, "__call__", injected)


def _recording(monkeypatch):
    drawn = []
    real = dropout.keep_mask

    def recording(seed, site, tensor, shape, rate, device=None):
        mask = real(seed, site, tensor, shape, rate, device)
        drawn.append((tuple(shape), rate, mask.numpy()))
        return mask

    monkeypatch.setattr(dropout, "keep_mask", recording)
    return drawn


@pytest.mark.parametrize("route,shape,cs,shift,strategy,padding_type,attn_drop,proj_drop",
                         ROUTE_CASES)
def test_train_mode_route_matches_flax_with_injected_masks(monkeypatch, route, shape, cs, shift,
                                                           strategy, padding_type, attn_drop,
                                                           proj_drop):
    C, heads = 64, 4   # a width the v4 kernels take (at 32 the layer routes to einsum)
    jl = JaxLayer(dim=C, num_heads=heads, cuboid_size=cs, shift_size=shift, strategy=strategy,
                  padding_type=padding_type, attn_drop=attn_drop, proj_drop=proj_drop)
    rs = np.random.RandomState(30)
    x = rs.randn(2, *shape, C).astype(np.float32)
    params = randomize_flax(jl.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 31)
    tl = CuboidSelfAttentionLayer(C, heads, cs, shift, strategy, padding_type, attn_drop,
                                  proj_drop).train()
    tl.load_state_dict(flax_params_to_torch(tl, params))
    assert tl.route(x.shape) == route and tl.eval().route(x.shape) != "grouped_einsum"
    tl.train()
    drawn = _recording(monkeypatch)
    xt = torch.from_numpy(x).requires_grad_(True)
    stream = dropout.DropoutStream(17)
    out = tl(xt, stream)
    assert stream.site == 1 and len(drawn) == (attn_drop > 0) + (proj_drop > 0)
    masks = list(drawn)                       # the forward's draws (the backward draws again)
    g = rs.randn(*out.shape).astype(np.float32)
    names = [n for n, _ in tl.named_parameters()]
    got = torch.autograd.grad(out, [xt] + list(tl.parameters()), torch.from_numpy(g))

    pending = list(masks)
    _inject(monkeypatch, pending)
    want, vjp = jax.vjp(lambda p, a: jl.apply({"params": p}, a, deterministic=False,
                                              rngs={"dropout": jax.random.PRNGKey(0)}),
                        params, jnp.asarray(x))
    assert not pending
    _close("out", out.detach().numpy(), want, TOL_FWD)
    gp, gx = vjp(jnp.asarray(g))
    _close("dx", got[0].numpy(), gx, TOL_GRAD)
    want_p = flax_params_to_torch(tl, gp)
    for name, gt in zip(names, got[1:]):
        _close(name, gt.numpy(), want_p[name].numpy(), TOL_GRAD)


# ---- the slice: a tiny video_swin_2x2 UNet ----
def _swin_over(**latent):
    """configs/tiny_smoke.yaml with video_swin_2x2 and 2 context frames: T = 4
    in the UNet, where both stages route a v4 and a grouped_masked layer; at
    base_units 64, a width the general layer's kernels take (at the config's
    16 its unshifted windows take the einsum route)."""
    return {"layout": {"in_len": 2},
            "model": {"diffusion": {"latent_cond_shape": [2, 4, 4, 8]},
                      "latent_model": dict(input_shape=[2, 4, 4, 8], self_pattern=PATTERN,
                                           base_units=64, **latent)}}


def _swin_cfg(**latent):
    cfg = load_config(prediff_default_config, TINY)
    return ConfigDict.wrap(deep_merge(cfg.to_dict(), _swin_over(**latent)))


def _routes(model):
    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, inp: seen.append(mod.route(inp[0].shape)))
             for m in model.modules() if isinstance(m, CuboidSelfAttentionLayer)]
    return seen, hooks


def test_tiny_swin_unet_in_training_mode_matches_jax_grad(monkeypatch):
    """Rates 0, training mode: the output and the gradient of every leaf
    against ``jax.vjp`` of the flax UNet; the v4 layers' backward is the
    all-gradients one (never dx alone plus autograd of a plain version)."""
    jcfg = jax_load_config(jax_default_config, TINY)
    jcfg = type(jcfg).wrap(deep_merge(jcfg.to_dict(), _swin_over()))
    junet = jax_build_unet(jcfg)
    rs = np.random.RandomState(40)
    x, cond = (rs.randn(2, 2, 4, 4, 8).astype(np.float32) for _ in range(2))
    t = np.array([1, 6], np.int32)
    params = randomize_flax(junet.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(cond))["params"], 41)
    tunet = build_unet(_swin_cfg()).train()
    tunet.load_state_dict(flax_params_to_torch(tunet, params))
    calls = {"bwd_full": 0, "bwd_dx": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(attention, "cuboid_attention_bwd_full_plain",
                        counting("bwd_full", attention.cuboid_attention_bwd_full_plain))
    monkeypatch.setattr(attention, "cuboid_attention_bwd_dx_plain",
                        counting("bwd_dx", attention.cuboid_attention_bwd_dx_plain))
    seen, hooks = _routes(tunet)
    out = tunet(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(cond))
    for h in hooks:
        h.remove()
    assert set(seen) == {"v4", "grouped_masked"}
    g = rs.randn(*out.shape).astype(np.float32)
    names = [n for n, _ in tunet.named_parameters()]
    got = torch.autograd.grad(out, list(tunet.parameters()), torch.from_numpy(g))
    assert calls == {"bwd_full": seen.count("v4"), "bwd_dx": 0}

    want, vjp = jax.vjp(lambda p: junet.apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                                              jnp.asarray(cond), deterministic=False), params)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_p = flax_params_to_torch(tunet, vjp(jnp.asarray(g))[0])
    checked = 0
    for name, gt in zip(names, got):
        w = want_p[name]
        scale = float(w.abs().max())
        err = float((gt - w).abs().max())
        assert err <= TOL_GRAD * max(scale, 1.0), name
        # also against the leaf's own scale, where a GroupNorm after it does not
        # cancel its gradient to rounding noise (a conv bias before a GroupNorm)
        if scale >= 1e-3:
            assert err <= 1e-2 * scale, name
            checked += 1
    assert checked > len(names) // 2


def _trainer(cfg, seed=3):
    ld = build_training_pipeline(cfg, device="cpu", seed=seed)
    init_params_(ld.unet, torch.Generator().manual_seed(seed), randomize=True)
    return ld, DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=8, accum_steps=2))


def _batch(cfg, seed=0):
    L = cfg.layout
    b = torch.from_numpy(np.random.RandomState(seed).rand(
        2, L.in_len + L.out_len, L.img_height, L.img_width, 1).astype(np.float32))
    return b[:, L.in_len:], b[:, :L.in_len]


def test_swin_train_step_repeats_from_one_seed_and_checkpoint_round_trips(tmp_path):
    """The recipe's rates 0.1: the v4 layers run the dropout functions, the
    shifted windows the einsum route; a train step repeats bit for bit from
    one seed, and a run restored from a checkpoint repeats the run it was
    saved from."""
    cfg = _swin_cfg(**RATES)
    x, y = _batch(cfg)
    runs = []
    for _ in range(2):
        ld, trainer = _trainer(cfg)
        state = trainer.create_state()
        seen, hooks = _routes(ld.unet)
        losses = []
        for _ in range(3):
            state, out = trainer.train_step(state, 5, x, y)
            losses.append(float(out["train/loss"]))
        for h in hooks:
            h.remove()
        runs.append((losses, state, trainer))
    assert set(seen) == {"v4", "grouped_einsum"}
    assert runs[0][0] == runs[1][0] and np.isfinite(runs[0][0]).all()
    assert len(set(runs[0][0])) == 3                  # each micro-step draws its own masks
    state, trainer = runs[0][1], runs[0][2]
    assert state.tx.count == 1
    assert all(torch.equal(a, runs[1][1].params[k]) for k, a in state.params.items())
    save_checkpoint(str(tmp_path / "ckpt"), state)    # in the middle of an accumulation
    _, trainer2 = _trainer(cfg)          # the same frozen VAE; the UNet comes from the checkpoint
    for p in trainer2.ld.unet.parameters():
        p.data.zero_()
    fresh = trainer2.create_state()
    restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    state, a = trainer.train_step(state, 5, x, y)
    fresh, b = trainer2.train_step(fresh, 5, x, y)
    assert float(a["train/loss"]) == float(b["train/loss"]) and state.tx.count == 2
    assert all(torch.equal(fresh.params[k], p) for k, p in state.params.items())
