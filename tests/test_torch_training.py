"""Diffusion training of the port against the JAX package on
configs/tiny_smoke.yaml (CPU, f32, dropout rates 0): the loss and the
gradient of every leaf with the same randomized weights and the same z, zc,
t and noise; accumulated optimizer steps with EMA against
``EmaTrainState.apply_gradients`` + ``build_optimizer``; the trainer, the
checkpoint round trip, the loop; and the dropout rates, honoured in training
mode and ignored in eval mode (``test_torch_dropout.py`` holds the masked
functions to the JAX kernels)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.diffusion import core as jax_core
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.training.diffusion_trainer import optax_global_norm
from prediff_tpu.training.ema import ema_decay as jax_ema_decay
from prediff_tpu.training.optim import build_lr_schedule as jax_build_lr_schedule
from prediff_tpu.training.optim import build_optimizer as jax_build_optimizer
from prediff_tpu.training.train_state import EmaTrainState as JaxEmaTrainState
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.datasets.synthetic import synthetic_batch_iterator
from prediff_torch.diffusion import core
from prediff_torch.factory import build_pipeline, build_training_pipeline, build_unet, build_vae
from prediff_torch.training import (CheckpointTracker, DiffusionTrainer, EmaTrainState,
                                    build_lr_schedule, build_optimizer, ema_decay, fit)
from prediff_torch.training.diffusion_trainer import step_generator
from prediff_torch.training.optim import global_norm
from prediff_torch.utils.checkpoint import (all_steps, load_params_npz, restore_checkpoint,
                                            save_checkpoint, save_params_npz)
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 on both sides; the sums of a forward and a backward run in another order
TOL_GRAD = 1e-4
# the same gradients into both optimizers: only the rounding of the update differs
TOL_STEP = 1e-5


@pytest.fixture(scope="module")
def both():
    """The JAX pipeline and the port's training pipeline on the tiny config
    with the same randomized weights, and one set of z, zc, t, noise."""
    jcfg = jax_load_config(jax_default_config, TINY)
    jld, jparams = jax_build_pipeline(jcfg, with_alignment=False)
    unet_p = randomize_flax(jparams["unet"], 11)
    vae_p = randomize_flax(jparams["vae"], 12)
    tcfg = load_config(prediff_default_config, TINY)
    state = {"unet": flax_params_to_torch(build_unet(tcfg), unet_p),
             "vae": flax_params_to_torch(build_vae(tcfg), vae_p)}
    ld = build_training_pipeline(tcfg, device="cpu", params=state)
    rs = np.random.RandomState(13)
    draws = dict(z=rs.randn(2, 2, 4, 4, 8).astype(np.float32),
                 zc=rs.randn(2, 3, 4, 4, 8).astype(np.float32),
                 t=np.array([1, 6], np.int32), noise=rs.randn(2, 2, 4, 4, 8).astype(np.float32))
    logvar = (0.3 * rs.randn(jld.num_timesteps)).astype(np.float32)
    return jld, unet_p, ld, tcfg, draws, logvar


_JITTED = {}


def _jax_loss_and_grads(jld, params, d):
    """((loss, loss_dict), grads) of the JAX p_losses; compiled once per pipeline."""
    if id(jld) not in _JITTED:
        def loss_fn(p, z, zc, t, noise):
            return jld.p_losses(p["unet"], p["logvar"], z, zc, t, noise, train=False)
        _JITTED[id(jld)] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    return _JITTED[id(jld)](params, *(jnp.asarray(d[k]) for k in ("z", "zc", "t", "noise")))


def _torch_draws(d):
    return (torch.from_numpy(d["z"]), torch.from_numpy(d["zc"]),
            torch.from_numpy(d["t"]).long(), torch.from_numpy(d["noise"]))


def test_diffusion_loss_matches_jax():
    rs = np.random.RandomState(0)
    out, x0, noise = (rs.randn(3, 2, 4, 4, 8).astype(np.float32) for _ in range(3))
    t = np.array([0, 3, 7])
    logvar = (0.5 * rs.randn(8)).astype(np.float32)
    from prediff_tpu.diffusion.schedule import make_gaussian_schedule as jax_schedule
    from prediff_torch.diffusion.schedule import make_gaussian_schedule
    kw = dict(learn_logvar=True, original_elbo_weight=0.3, l_simple_weight=0.7, prefix="val")
    for loss_type in ("l2", "l1"):
        want, wd = jax_core.diffusion_loss(jax_schedule(timesteps=8), *map(jnp.asarray, (out, x0, noise)),
                                           jnp.asarray(t), jnp.asarray(logvar), loss_type=loss_type, **kw)
        got, gd = core.diffusion_loss(make_gaussian_schedule(timesteps=8),
                                      *map(torch.from_numpy, (out, x0, noise)), torch.from_numpy(t),
                                      torch.from_numpy(logvar), loss_type=loss_type, **kw)
        assert set(gd) == set(wd) == {"val/loss_simple", "val/loss_gamma", "logvar",
                                      "val/loss_vlb", "val/loss"}
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        for k in wd:
            np.testing.assert_allclose(float(gd[k]), float(wd[k]), rtol=1e-5, err_msg=k)


def test_p_losses_and_every_gradient_match_jax(both):
    jld, unet_p, ld, _, d, logvar = both
    assert jld.learn_logvar and ld.learn_logvar
    (want_loss, want_dict), jgrads = _jax_loss_and_grads(
        jld, {"unet": unet_p, "logvar": jnp.asarray(logvar)}, d)
    want = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jgrads))

    lv = torch.from_numpy(logvar).requires_grad_(True)
    loss, loss_dict = ld.p_losses(lv, *_torch_draws(d))
    names = [f"unet.{k}" for k, _ in ld.unet.named_parameters()] + ["logvar"]
    grads = torch.autograd.grad(loss, list(ld.unet.parameters()) + [lv])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=TOL_GRAD)
    assert set(loss_dict) == set(want_dict)
    for k in want_dict:
        np.testing.assert_allclose(float(loss_dict[k]), float(want_dict[k]), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)
    assert sorted(names) == sorted(want)
    nonzero = 0
    for name, g in zip(names, grads):
        w = want[name]
        assert g.shape == w.shape, name
        scale = max(float(w.abs().max()), 1e-3)
        assert float((g - w).abs().max()) <= TOL_GRAD * max(scale, 1.0), name
        # also relative to the leaf's own scale, so that a small leaf is not passed by default
        assert float((g - w).abs().max()) <= 1e-2 * scale, name
        nonzero += float(w.abs().max()) > 0
    assert nonzero == len(names)      # randomized weights: no leaf's gradient is trivially 0


def test_accumulated_optimizer_steps_match_optax(both):
    """Three optimizer steps of two micro-gradients each: parameters, EMA
    shadow, the rate and the gradient norm after every micro-step."""
    jld, unet_p, ld, _, d, logvar = both
    cfg = dict(lr=1e-3, total_num_steps=4, wd=1e-2, gradient_clip_val=0.05,
               warmup_percentage=0.5, min_lr_ratio=0.1, warmup_min_lr_ratio=0.2, accum_steps=2)
    jparams = {"unet": unet_p, "logvar": jnp.asarray(logvar)}
    jstate = JaxEmaTrainState.create(jparams, jax_build_optimizer(**cfg), ema_decay=0.9)
    jsched = jax_build_lr_schedule(cfg["lr"], cfg["total_num_steps"], cfg["warmup_percentage"],
                                   "cosine", cfg["min_lr_ratio"], cfg["warmup_min_lr_ratio"])

    start = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jparams))
    params = {k: torch.nn.Parameter(v.clone()) for k, v in start.items()}
    state = EmaTrainState.create(params, build_optimizer(list(params.values()), **cfg),
                                 ema_decay=0.9)
    sched = build_lr_schedule(cfg["lr"], cfg["total_num_steps"], cfg["warmup_percentage"],
                              "cosine", cfg["min_lr_ratio"], cfg["warmup_min_lr_ratio"])
    for count in range(6):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6)
    np.testing.assert_allclose(sched(0), cfg["lr"] * cfg["warmup_min_lr_ratio"], rtol=1e-12)

    japply = jax.jit(lambda st, g: st.apply_gradients(g))
    rs = np.random.RandomState(14)
    for micro in range(6):
        dd = dict(d, noise=rs.randn(*d["noise"].shape).astype(np.float32))
        _, jgrads = _jax_loss_and_grads(jld, jstate.params, dd)
        grads = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jgrads))
        norm = float(global_norm(grads.values()))
        np.testing.assert_allclose(norm, float(optax_global_norm(jgrads)), rtol=TOL_STEP)
        assert norm > cfg["gradient_clip_val"]          # the clip bites
        np.testing.assert_allclose(state.tx.lr, float(jsched(micro // 2)), rtol=1e-6)
        np.testing.assert_allclose(ema_decay(0.9, state.step),
                                   float(jax_ema_decay(0.9, jstate.step)), rtol=1e-6)
        jstate = japply(jstate, jgrads)
        state.apply_gradients([grads[k] for k in state.params])
        assert state.step == int(jstate.step) == micro + 1
        want_p = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jstate.params))
        want_e = flax_train_tree_to_torch(ld.unet,
                                          jax.tree_util.tree_map(np.asarray, jstate.ema_params))
        moved = 0.0
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), want_p[k].numpy(), rtol=TOL_STEP,
                                       atol=TOL_STEP, err_msg=f"param {k} after micro-step {micro}")
            np.testing.assert_allclose(state.ema_params[k].numpy(), want_e[k].numpy(),
                                       rtol=TOL_STEP, atol=TOL_STEP, err_msg=f"ema {k}")
            moved = max(moved, float((p.detach() - start[k]).abs().max()))
        if micro == 0:
            assert moved == 0.0          # no update between two optimizer steps
    assert moved > 1e-4 and state.tx.count == 3


def _tiny_trainer(tcfg, **kw):
    ld = build_training_pipeline(tcfg, device="cpu", seed=3)
    optim = dict(lr=1e-3, total_num_steps=8, accum_steps=2)
    return ld, DiffusionTrainer(ld, optim_config=optim, **kw)


def _tiny_batches(tcfg, seed=0, n=4):
    L = tcfg.layout
    for b in synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height, L.img_width,
                                      seed=seed, num_batches=n):
        b = torch.from_numpy(b)
        yield b[:, L.in_len:], b[:, :L.in_len]


def test_train_step_is_the_manual_composition(both):
    tcfg = both[3]
    ld, trainer = _tiny_trainer(tcfg, track_grad_norm=True)
    state = trainer.create_state()
    x, y = next(_tiny_batches(tcfg))
    before = {k: p.detach().clone() for k, p in state.params.items()}

    gen = step_generator(5, 0, "cpu")
    z = ld.encode_first_stage(x, gen, sample_posterior=True)
    zc = ld.cond_stage_forward(y)
    t = torch.randint(0, ld.num_timesteps, (2,), generator=gen)
    noise = torch.randn(z.shape, generator=gen)
    loss, _ = ld.p_losses(state.params["logvar"], z, zc, t, noise)
    grads = torch.autograd.grad(loss, list(state.params.values()))

    state, loss_dict = trainer.train_step(state, 5, x, y)
    assert float(loss_dict["train/loss"]) == float(loss)
    assert float(loss_dict["grad_norm"]) == float(global_norm(grads))
    keys = {"train/loss", "train/loss_simple", "train/loss_gamma", "train/loss_vlb", "logvar",
            "grad_norm", "grad_norm/logvar", "grad_norm/unet.first_proj",
            "grad_norm/unet.down_self_blocks_0_0", "grad_norm/unet.final_proj"}
    assert keys <= set(loss_dict)
    assert state.step == 1 and state.tx.count == 0
    assert all(torch.equal(p, before[k]) for k, p in state.params.items())   # accumulating
    state, _ = trainer.train_step(state, 5, x, y)
    assert state.tx.count == 1
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
    # another step count, other draws; the same seed and step, the same draws
    assert not torch.equal(torch.randn(4, generator=step_generator(5, 0, "cpu")),
                           torch.randn(4, generator=step_generator(5, 1, "cpu")))
    assert torch.equal(torch.randn(4, generator=step_generator(5, 7, "cpu")),
                       torch.randn(4, generator=step_generator(torch.Generator().manual_seed(5), 7, "cpu")))


def test_val_step_uses_the_ema_weights(both):
    tcfg = both[3]
    ld, trainer = _tiny_trainer(tcfg)
    state = trainer.create_state()
    x, y = next(_tiny_batches(tcfg))
    for _ in range(4):
        state, _ = trainer.train_step(state, 0, x, y)
    with_ema = trainer.val_step(state, 1, x, y, use_ema=True)
    without = trainer.val_step(state, 1, x, y, use_ema=False)
    assert set(with_ema) == {"val/loss", "val/loss_simple", "val/loss_gamma", "val/loss_vlb", "logvar"}
    assert float(with_ema["val/loss"]) != float(without["val/loss"])
    assert ld.unet.training
    # the EMA weights themselves, loaded into a second UNet, give the same loss
    ld2 = build_pipeline(tcfg, device="cpu", params={
        "unet": state.ema_param_tree("unet."), "vae": ld.vae.state_dict()})
    gen = step_generator(1, 0, "cpu")
    _, want = ld2.training_loss(state.params["logvar"].detach(), gen, x, y, prefix="val")
    np.testing.assert_allclose(float(with_ema["val/loss"]), float(want["val/loss"]), rtol=1e-6)


def test_training_from_moments_matches_pixels(both):
    tcfg = both[3]
    ld, trainer = _tiny_trainer(tcfg)
    state = trainer.create_state()
    x, y = next(_tiny_batches(tcfg))

    def moments(a):
        m = ld.first_stage_moments(a.reshape((-1,) + tuple(a.shape[2:])))
        return m.reshape(tuple(a.shape[:2]) + tuple(m.shape[1:]))

    pix = trainer.val_step(state, 2, x, y)
    lat = trainer.val_step(state, 2, moments(x), moments(y), latent_inputs=True)
    assert float(pix["val/loss"]) == float(lat["val/loss"])


def test_checkpoint_round_trip(both, tmp_path):
    tcfg = both[3]
    _, trainer = _tiny_trainer(tcfg)
    state = trainer.create_state()
    batches = list(_tiny_batches(tcfg, n=5))
    for x, y in batches[:3]:                       # saved in the middle of an accumulation
        state, _ = trainer.train_step(state, 0, x, y)
    save_checkpoint(str(tmp_path / "ckpt"), state)
    assert all_steps(str(tmp_path / "ckpt")) == [3]

    _, trainer2 = _tiny_trainer(tcfg)
    fresh = trainer2.create_state()
    restore_checkpoint(str(tmp_path / "ckpt"), fresh)
    assert fresh.step == 3 and fresh.tx.count == 1 and fresh.tx.mini_step == 1
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k]), k
        assert torch.equal(fresh.ema_params[k], state.ema_params[k]), k
    # the restored run repeats the run it was saved from, bit for bit
    for x, y in batches[3:]:
        state, a = trainer.train_step(state, 0, x, y)
        fresh, b = trainer2.train_step(fresh, 0, x, y)
        assert float(a["train/loss"]) == float(b["train/loss"])
    for k in state.params:
        assert torch.equal(fresh.params[k], state.params[k]), k

    save_params_npz(str(tmp_path / "p.npz"), state.ema_param_tree("unet."))
    back = load_params_npz(str(tmp_path / "p.npz"))
    assert all(torch.equal(back[k], v) for k, v in state.ema_param_tree("unet.").items())
    # keep=2 leaves the two newest steps
    for step in (4, 5, 6):
        save_checkpoint(str(tmp_path / "ckpt"), state, step=step, keep=2)
    assert all_steps(str(tmp_path / "ckpt")) == [5, 6]


class _State:
    step = 0

    def state_dict(self):
        return {"step": self.step}


def test_checkpoint_tracker_keeps_top_k_and_the_latest(tmp_path):
    tracker = CheckpointTracker(str(tmp_path), mode="min", save_top_k=2)
    ckpt = str(tmp_path / "ckpt")
    for step, score in [(1, 0.5), (2, 0.3), (3, 0.9), (4, 0.4), (5, 0.95)]:
        assert tracker.is_improvement(score) == (step != 3 and step != 5)
        if tracker.is_improvement(score):
            tracker.update(score, step, _State())
    assert [s for _, s in tracker.best] == [2, 4]
    assert all_steps(ckpt) == [2, 4]
    tracker_max = CheckpointTracker(str(tmp_path / "m"), mode="max", save_top_k=1)
    for step, score in [(1, 0.5), (2, 0.3), (3, 0.9)]:
        tracker_max.update(score, step, _State())
    assert tracker_max.best == [(0.9, 3)] and all_steps(str(tmp_path / "m" / "ckpt")) == [3]


def test_fit_stops_at_max_steps_validates_and_checkpoints(both, tmp_path):
    tcfg = both[3]
    _, trainer = _tiny_trainer(tcfg)
    state = trainer.create_state()
    vx, vy = next(_tiny_batches(tcfg, seed=9))
    seen = []

    def val_fn(s):
        seen.append(s.step)
        return {k: float(v) for k, v in trainer.val_step(s, 0, vx, vy).items()}

    state = fit(state, trainer.train_step, lambda epoch: _tiny_batches(tcfg, seed=epoch, n=4),
                lambda b: b, max_epochs=5, save_dir=str(tmp_path), seed=0, val_fn=val_fn,
                max_steps=6, log_every_n_steps=2)
    assert state.step == 6 and state.tx.count == 3
    assert seen == [4, 6]                       # end of epoch 0, then the stop in epoch 1
    assert set(all_steps(str(tmp_path / "ckpt"))) == {4, 6}
    import json
    lines = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in lines if "train/loss" in r] == [2, 4, 6]
    assert all(np.isfinite(r["train/loss"]) for r in lines if "train/loss" in r)
    # steps_per_call > 1 without a scan function is an error, as in the JAX loop
    with pytest.raises(ValueError, match="train_step_scan"):
        fit(state, trainer.train_step, lambda e: [], lambda b: b, 1, str(tmp_path), 0,
            steps_per_call=2)


def test_dropout_rates_are_refused_in_training_mode():
    """The name dates from when training mode refused every rate above 0.
    Now the rates are honoured in training mode and ignored in eval mode."""
    from prediff_torch.models.init import init_params_
    cfg = load_config(prediff_default_config)        # the v1 recipe: rates 0.1
    cfg.model.latent_model.update(input_shape=[3, 4, 4, 8], target_shape=[2, 4, 4, 8],
                                  base_units=16, depth=[1, 1])
    unet = init_params_(build_unet(cfg), torch.Generator().manual_seed(0), randomize=True)
    rs = torch.Generator().manual_seed(1)
    args = (torch.randn(1, 2, 4, 4, 8, generator=rs), torch.tensor([3]),
            torch.randn(1, 3, 4, 4, 8, generator=rs))
    unet.train()                                     # no refusal any more
    with pytest.raises(ValueError, match="dropout_seed"):     # but the masks need a seed
        unet(*args)
    with torch.no_grad():
        a, again, other = unet(*args, dropout_seed=5), unet(*args, dropout_seed=5), \
            unet(*args, dropout_seed=6)
        served = unet.eval()(*args)
        assert torch.equal(served, unet(*args, dropout_seed=5))      # eval ignores rates and seed
    assert torch.isfinite(a).all() and torch.equal(a, again)
    assert not torch.equal(a, other) and not torch.equal(a, served)
    cfg0 = load_config(prediff_default_config)
    cfg0.model.latent_model.update(cfg.model.latent_model, attn_drop=0.0, proj_drop=0.0,
                                   ffn_drop=0.0)
    unet0 = build_unet(cfg0)
    unet0.load_state_dict(unet.state_dict())
    with torch.no_grad():                            # eval mode is the rate-0 model, bit for bit
        assert torch.equal(served, unet0.train()(*args))
    L = load_config(prediff_default_config, TINY).model.latent_model
    targs = (torch.randn((2,) + tuple(L.target_shape), generator=rs), torch.tensor([1, 6]),
             torch.randn((2,) + tuple(L.input_shape), generator=rs))
    for rate in ("attn_drop", "proj_drop", "ffn_drop", "time_embed_dropout"):
        one = load_config(prediff_default_config, TINY)
        one.model.latent_model[rate] = 0.1
        ld = build_training_pipeline(one, device="cpu")       # each rate alone: builds and is live
        init_params_(ld.unet, torch.Generator().manual_seed(2), randomize=True)
        with torch.no_grad():
            dropped = ld.unet(*targs, dropout_seed=9)
            assert not torch.equal(dropped, ld.unet.eval()(*targs)), rate
    tiny = load_config(prediff_default_config, TINY)             # rates 0: trains without a seed
    ld = build_training_pipeline(tiny, device="cpu")
    assert ld.unet.training and all(p.requires_grad for p in ld.unet.parameters())
    assert torch.isfinite(ld.unet(*targs)).all()
    assert not any(p.requires_grad for p in ld.vae.parameters()) and not ld.vae.training
    served = build_pipeline(load_config(prediff_default_config, TINY), device="cpu")
    assert not served.unet.training and not any(p.requires_grad for p in served.unet.parameters())
    bad = load_config(prediff_default_config, TINY)
    bad.model.latent_model["use_pallas_dropout"] = False      # a TPU dispatch switch
    with pytest.raises(NotImplementedError, match="use_pallas_dropout"):
        build_unet(bad)


def test_tpu_knobs_are_refused(both):
    tcfg = both[3]
    ld = build_training_pipeline(tcfg, device="cpu")
    for knob in (dict(flat_update=True), dict(pack_small_thr=1024),
                 dict(matmul_precision="bfloat16")):
        with pytest.raises(NotImplementedError):
            DiffusionTrainer(ld, **knob)
    # the mesh is taken (DDP training; two ranks in tests/test_torch_ddp_training.py),
    # on the pipeline's device only
    from prediff_torch.parallel import make_mesh
    assert DiffusionTrainer(ld, mesh=make_mesh(device="cpu")).mesh.size == 1
    with pytest.raises(ValueError, match="device"):
        DiffusionTrainer(ld, mesh=make_mesh(device="meta"))
    DiffusionTrainer(ld, prng_impl="auto", conv3d_impl="auto")      # the configs' defaults
