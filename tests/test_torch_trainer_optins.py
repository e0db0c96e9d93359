"""The trainer opt-ins of the port against the JAX package on the CPU:
``state_dtype`` (Adam moments stored in bf16) against ``build_optimizer`` +
``EmaTrainState.apply_gradients``, ``ema_dtype`` (a bf16 EMA shadow),
``remat_unet`` (gradients bit-equal to the step without it at dropout 0.1,
and against the JAX trainer's ``jax.checkpoint`` step at rates 0), the
checkpoints of a bf16 state, and the program that reads both dtypes from its
configuration."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_training import TOL_GRAD, TOL_STEP
from test_torch_unet import randomize_flax

import prediff_tpu.utils.distributions as jax_dist
import prediff_torch.diffusion.latent_diffusion as tld
import prediff_torch.utils.distributions as torch_dist
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.training.diffusion_trainer import DiffusionTrainer as JaxDiffusionTrainer
from prediff_tpu.training.optim import build_optimizer as jax_build_optimizer
from prediff_tpu.training.train_state import EmaTrainState as JaxEmaTrainState
from prediff_torch.cli import train_sevirlr_prediff
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.datasets import make_synthetic_sevir_lr
from prediff_torch.datasets.synthetic import synthetic_batch_iterator
from prediff_torch.factory import build_training_pipeline, build_unet, build_vae
from prediff_torch.models.init import init_params_
from prediff_torch.training import DiffusionTrainer, EmaTrainState, build_optimizer
from prediff_torch.utils.checkpoint import all_steps, restore_checkpoint, save_checkpoint
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
RATES = dict(attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1, time_embed_dropout=0.1)
SHAPES = {"a": (3, 3, 3, 8, 16), "b": (16,), "c": (64, 32), "d": (5,)}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One unit in the last place of bfloat16 at |x| (8 significant bits)."""
    a = x.abs().float().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _assert_within_one_ulp(got: torch.Tensor, want: torch.Tensor, what: str):
    """Within one bf16 ulp of the larger of the two, on top of what the f32
    inputs' own differences give (the clipped gradients' global norms sum in
    another order; the parameters are within ``TOL_STEP``): 1e-6 of the
    leaf's largest value, which only an element that cancels to near 0 needs."""
    assert got.dtype == want.dtype == torch.bfloat16, what
    got, want = got.float(), want.float()
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6 * float(want.abs().max())
    assert bool(((got - want).abs() <= ulp).all()), \
        f"{what}: {float((got - want).abs().max())} beyond one bf16 ulp"


def _tree(rs):
    return {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _jax_moments(jstate):
    """(mu, nu) of the JAX state: the MultiSteps inner state's Adam moments."""
    found = []

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            found.append((s.mu, s.nu))
        elif isinstance(s, (tuple, list)):
            for v in s:
                walk(v)
        elif hasattr(s, "inner_opt_state"):
            walk(s.inner_opt_state)

    walk(jstate.opt_state)
    assert len(found) == 1
    return found[0]


@pytest.mark.parametrize("method,state_dtype,ema_dtype", [
    ("adamw", "bfloat16", None), ("adam", "bfloat16", None), ("adamw", None, "bfloat16"),
    ("adamw", "bfloat16", "bfloat16")])
def test_low_precision_state_matches_jax(method, state_dtype, ema_dtype):
    """Three optimizer steps of two micro-gradients each, the clip biting on
    every one: parameters within ``TOL_STEP`` after every micro-step, the
    moments and the EMA shadow stored in bf16 on both sides, within one bf16
    ulp; ``ema_param_tree`` gives f32."""
    rs = np.random.RandomState(3)
    # the rate of test_torch_training.py: a moment stored one bf16 ulp apart
    # (a tie rounded the other way) moves its parameter by 2^-8 of a step
    cfg = dict(lr=1e-3, total_num_steps=4, method=method, wd=1e-2, gradient_clip_val=0.5,
               warmup_percentage=0.5, min_lr_ratio=0.1, warmup_min_lr_ratio=0.2, accum_steps=2,
               state_dtype=state_dtype)
    start = _tree(rs)
    jstate = JaxEmaTrainState.create(jax.tree_util.tree_map(jnp.asarray, start),
                                     jax_build_optimizer(**cfg), ema_decay=0.9,
                                     ema_dtype=ema_dtype)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in start.items()}
    state = EmaTrainState.create(params, build_optimizer(list(params.values()), **cfg),
                                 ema_decay=0.9, ema_dtype=ema_dtype)
    japply = jax.jit(lambda st, g: st.apply_gradients(g))
    for micro in range(6):
        grads = {k: (2.0 * rs.randn(*s)).astype(np.float32) for k, s in SHAPES.items()}
        jstate = japply(jstate, jax.tree_util.tree_map(jnp.asarray, grads))
        state.apply_gradients([torch.from_numpy(grads[k]) for k in state.params])
        for k, p in state.params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.params[k]),
                                       rtol=TOL_STEP, atol=TOL_STEP,
                                       err_msg=f"param {k} after micro-step {micro}")
        if ema_dtype is not None:
            for k, e in state.ema_params.items():
                want = torch.from_numpy(np.asarray(jstate.ema_params[k].astype(jnp.float32)))
                assert jstate.ema_params[k].dtype == jnp.bfloat16
                _assert_within_one_ulp(e, want.to(torch.bfloat16), f"ema {k}")
            tree = state.ema_param_tree()
            assert all(v.dtype == torch.float32 for v in tree.values())
            assert all(torch.equal(tree[k], e.float()) for k, e in state.ema_params.items())
        if state_dtype is not None and micro % 2 == 1:
            mu, nu = _jax_moments(jstate)
            st = state.tx.optimizer.state
            for k, p in state.params.items():
                for name, want in (("exp_avg", mu[k]), ("exp_avg_sq", nu[k])):
                    assert want.dtype == jnp.bfloat16
                    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
                    _assert_within_one_ulp(st[p][name], want.to(torch.bfloat16),
                                           f"{name} {k} after micro-step {micro}")
    assert state.tx.count == 3
    moved = max(float((p.detach() - torch.from_numpy(start[k])).abs().max())
                for k, p in state.params.items())
    assert moved > 1e-4
    held = [t for t in state.tensors() if t.dtype == torch.bfloat16]
    assert len(held) == (2 * len(SHAPES) if state_dtype else 0) + (len(SHAPES) if ema_dtype
                                                                    else 0)


def test_state_dtypes_refused_and_float16():
    p = [torch.nn.Parameter(torch.randn(4, 4))]
    for bad in ("int8", "bf16", torch.bfloat16):
        with pytest.raises(ValueError):
            build_optimizer(p, state_dtype=bad)
        with pytest.raises(ValueError):
            EmaTrainState.create({"w": p[0]}, build_optimizer(p), ema_dtype=bad)
    with pytest.raises(ValueError, match="float32"):
        build_optimizer([torch.nn.Parameter(torch.randn(3, dtype=torch.float64))],
                        state_dtype="bfloat16")
    tx = build_optimizer(p, state_dtype="float16", gradient_clip_val=None)
    state = EmaTrainState.create({"w": p[0]}, tx, ema_dtype="float16")
    state.apply_gradients([torch.randn(4, 4)])
    assert all(v.dtype == torch.float16 for v in tx.optimizer.state[p[0]].values())
    assert state.ema_params["w"].dtype == torch.float16


@pytest.fixture(scope="module")
def pair():
    """The JAX pipeline and the port's training pipeline on the tiny
    configuration with the same randomized UNet and VAE (rates 0)."""
    jcfg = jax_load_config(jax_default_config, TINY)
    jld, jparams = jax_build_pipeline(jcfg, with_alignment=False)
    unet_p = randomize_flax(jparams["unet"], 21)
    vae_p = randomize_flax(jparams["vae"], 22)
    tcfg = load_config(prediff_default_config, TINY)
    state = {"unet": flax_params_to_torch(build_unet(tcfg), unet_p),
             "vae": flax_params_to_torch(build_vae(tcfg), vae_p)}
    ld = build_training_pipeline(tcfg, device="cpu", params=state)
    return jld, unet_p, vae_p, ld, tcfg


def _batch(tcfg, seed=0):
    L = tcfg.layout
    b = torch.from_numpy(next(synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height,
                                                       L.img_width, seed=seed)))
    return b[:, L.in_len:], b[:, :L.in_len]


def test_remat_step_matches_the_jax_remat_step(pair, monkeypatch):
    """Rates 0: the port's ``remat_unet`` micro-step against the JAX
    trainer's loss under ``jax.checkpoint`` and its gradients, the same t,
    noise and posterior noise injected on both sides."""
    jld, unet_p, vae_p, ld, tcfg = pair
    x, y = _batch(tcfg)
    rs = np.random.RandomState(23)
    t = np.array([2, 5], np.int32)
    noise = rs.randn(2, *tcfg.model.diffusion.latent_shape).astype(np.float32)
    eps = {}

    def eps_of(shape):
        if shape not in eps:
            eps[shape] = np.random.RandomState(24).randn(*shape).astype(np.float32)
        return eps[shape]

    monkeypatch.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            eps_of(tuple(self.mean.shape))))
    monkeypatch.setattr(torch_dist.DiagonalGaussianDistribution, "sample",
                        lambda self, generator=None, rows=None: self.mean + self.std *
                        torch.from_numpy(eps_of(tuple(self.mean.shape))))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(tld, "randint_rows", lambda *a, **k: torch.from_numpy(t).long())
    monkeypatch.setattr(tld, "randn_rows", lambda *a, **k: torch.from_numpy(noise))

    logvar = (0.3 * rs.randn(jld.num_timesteps)).astype(np.float32)
    jtr = JaxDiffusionTrainer(jld, vae_p, remat_unet=True)
    jparams = {"unet": unet_p, "logvar": jnp.asarray(logvar)}
    (want_loss, want_dict), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr._loss_fn(p, jax.random.PRNGKey(0), jnp.asarray(x.numpy()),
                               jnp.asarray(y.numpy()), True, "train"), has_aux=True))(jparams)
    want = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jgrads))

    trainer = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=8),
                               remat_unet=True)
    state = trainer.create_state()
    with torch.no_grad():
        state.params["logvar"].copy_(torch.from_numpy(logvar))
    grads, loss_dict = trainer.grads(state, 0, x, y)
    assert not ld.unet.remat                          # set for the step only
    np.testing.assert_allclose(float(loss_dict["train/loss"]), float(want_loss), rtol=TOL_GRAD)
    for k in want_dict:
        np.testing.assert_allclose(float(loss_dict[k]), float(want_dict[k]), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)
    assert sorted(state.params) == sorted(want)
    for name, g in zip(state.params, grads):
        w = want[name]
        scale = max(float(w.abs().max()), 1e-3)
        assert float((g - w).abs().max()) <= TOL_GRAD * max(scale, 1.0), name
        assert float((g - w).abs().max()) <= 1e-2 * scale, name


@pytest.mark.parametrize("variant", ["pixels", "latents", "global_vectors"])
def test_remat_gradients_bit_equal_at_the_recipe_rates(variant):
    """Rates 0.1: the loss and every gradient of a micro-step with
    ``remat_unet`` equal the step without it, bit for bit (the recomputed
    segments replay their dropout sites); the draws stay outside the
    segments, and validation never recomputes."""
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(RATES)
    if variant == "global_vectors":
        cfg.model.latent_model.update(num_global_vectors=2)
    ld = build_training_pipeline(cfg, device="cpu", seed=4)
    init_params_(ld.unet, torch.Generator().manual_seed(5), randomize=True)
    x, y = _batch(cfg, seed=1)
    latent = variant == "latents"
    if latent:
        def moments(a):
            m = ld.first_stage_moments(a.reshape((-1,) + tuple(a.shape[2:])))
            return m.reshape(tuple(a.shape[:2]) + tuple(m.shape[1:]))
        x, y = moments(x), moments(y)
    runs = {}
    for remat in (False, True):
        trainer = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=8),
                                   latent_inputs=latent, remat_unet=remat)
        state = trainer.create_state()
        runs[remat] = trainer.grads(state, 7, x, y) + (trainer.val_step(state, 7, x, y),)
    (g0, d0, v0), (g1, d1, v1) = runs[False], runs[True]
    assert all(torch.equal(d0[k], d1[k]) for k in d0)
    assert len(g0) == len(g1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert any(float(g.abs().max()) > 0 for g in g1)
    assert all(torch.equal(v0[k], v1[k]) for k in v0)


def test_bf16_state_checkpoints(tmp_path):
    """A bf16-state trainer's checkpoint restores bit for bit and the
    restored run repeats the saved one; an f32 checkpoint restored into a
    bf16 state raises, and a bf16 one into an f32 state."""
    cfg = load_config(prediff_default_config, TINY)

    def trainer(**kw):
        ld = build_training_pipeline(cfg, device="cpu", seed=3)
        optim = dict(lr=1e-3, total_num_steps=8, accum_steps=2, state_dtype=kw.pop("state", None))
        return DiffusionTrainer(ld, optim_config=optim, **kw)

    batches = [_batch(cfg, seed=s) for s in range(5)]
    tr = trainer(state="bfloat16", ema_dtype="bfloat16")
    state = tr.create_state()
    for x, y in batches[:3]:
        state, _ = tr.train_step(state, 0, x, y)
    save_checkpoint(str(tmp_path / "bf16"), state)
    tr2 = trainer(state="bfloat16", ema_dtype="bfloat16")
    fresh = restore_checkpoint(str(tmp_path / "bf16"), tr2.create_state())
    a, b = state.state_dict(), fresh.state_dict()
    opt_a, opt_b = a["opt_state"]["optimizer"]["state"], b["opt_state"]["optimizer"]["state"]
    assert opt_a and all(torch.equal(opt_a[i][k], opt_b[i][k]) and
                         opt_b[i][k].dtype == torch.bfloat16 for i in opt_a for k in opt_a[i])
    assert all(torch.equal(a["ema_params"][k], b["ema_params"][k]) and
               b["ema_params"][k].dtype == torch.bfloat16 for k in a["ema_params"])
    for x, y in batches[3:]:
        state, la = tr.train_step(state, 0, x, y)
        fresh, lb = tr2.train_step(fresh, 0, x, y)
        assert float(la["train/loss"]) == float(lb["train/loss"])
    assert all(torch.equal(fresh.params[k], state.params[k]) for k in state.params)
    assert all(torch.equal(fresh.ema_params[k], state.ema_params[k]) for k in state.params)

    f32 = trainer()
    s32 = f32.create_state()
    for x, y in batches[:2]:
        s32, _ = f32.train_step(s32, 0, x, y)
    save_checkpoint(str(tmp_path / "f32"), s32)
    for kw in (dict(state="bfloat16", ema_dtype="bfloat16"), dict(state="bfloat16"),
               dict(ema_dtype="bfloat16")):
        with pytest.raises(ValueError):
            restore_checkpoint(str(tmp_path / "f32"), trainer(**kw).create_state())
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path / "bf16"), trainer().create_state())


def test_train_program_reads_both_dtypes(tmp_path):
    """``train_sevirlr_prediff`` from a configuration with
    ``optim.state_dtype`` and ``optim.ema_dtype`` set: it trains, and its
    checkpoint holds bf16 moments and a bf16 shadow."""
    with open(TINY) as f:
        tree = yaml.safe_load(f)
    tree.setdefault("optim", {}).update(state_dtype="bfloat16", ema_dtype="bfloat16")
    cfg_path = str(tmp_path / "bf16_state.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(tree, f)
    sevir = str(tmp_path / "synthetic_sevirlr")
    make_synthetic_sevir_lr(sevir, num_events=8, H=32, W=32, T=25)
    save = str(tmp_path / "run")
    assert train_sevirlr_prediff.main(["--save", save, "--cfg", cfg_path, "--sevir-dir", sevir,
                                       "--device", "cpu", "--max-steps", "2"]) == 0
    ckpt = os.path.join(save, "checkpoints")
    steps = all_steps(ckpt) if os.path.isdir(ckpt) else []
    files = [os.path.join(dp, f) for dp, _, fs in os.walk(save) for f in fs if f.endswith(".pt")]
    assert files, "no checkpoint written"
    saved = torch.load(files[0], map_location="cpu", weights_only=True)
    if "state" in saved:      # a wrapped checkpoint
        saved = saved["state"]
    assert saved["opt_state"]["state_dtype"] == "bfloat16"
    moments = [v for st in saved["opt_state"]["optimizer"]["state"].values() for v in st.values()]
    assert moments and all(v.dtype == torch.bfloat16 for v in moments)
    assert all(v.dtype == torch.bfloat16 for v in saved["ema_params"].values())
    assert steps is not None
