"""K diffusion micro-steps per call (``DiffusionTrainer.train_step_scan``,
``steps_per_call``) on the CPU: against the JAX trainer's ``train_step_scan``
at rates 0 with the draws injected on both sides, within ``TOL_STEP``
(Adam's sign flips of gradients that are 0 up to rounding bounded apart);
against K calls of ``train_step`` at the recipe's rates 0.1, bit for bit
(the captured micro-step's code, run eagerly: the draws injected from
buffers, the dropout seed on the device, the train state's device scalars).
The opt-ins and the mesh: ``tests/test_torch_scan_optins.py``,
``tests/test_torch_scan_mesh.py``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_training import TOL_GRAD, TOL_STEP
from test_torch_unet import randomize_flax

import prediff_tpu.utils.distributions as jax_dist
import prediff_torch.diffusion.latent_diffusion as tld
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.training.diffusion_trainer import DiffusionTrainer as JaxDiffusionTrainer
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.datasets.synthetic import synthetic_batch_iterator
from prediff_torch.factory import build_training_pipeline, build_unet, build_vae
from prediff_torch.training import DiffusionTrainer
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
RATES = dict(attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1, time_embed_dropout=0.1)
# an update inside a call (accum 2, K 3), the clip biting, the EMA on its warm-up ramp
OPTIM = dict(lr=1e-3, total_num_steps=6, wd=1e-2, gradient_clip_val=0.05,
             warmup_percentage=0.5, min_lr_ratio=0.1, warmup_min_lr_ratio=0.2, accum_steps=2)
K = 3


def _stacks(cfg, n, seed):
    """n (x, y) micro-batches of 2 windows, stacked (n, 2, ...)."""
    L = cfg.layout
    it = synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height, L.img_width, seed=seed)
    b = torch.from_numpy(np.stack([next(it) for _ in range(n)]))
    return b[:, :, L.in_len:].contiguous(), b[:, :, :L.in_len].contiguous()


def test_scan_matches_the_jax_train_step_scan(monkeypatch):
    """Rates 0: one call of K = 3 micro-steps against the JAX trainer's
    ``train_step_scan`` from the same weights, with t, the noise and the
    posterior's noise injected on both sides: the stacked metrics within
    ``TOL_GRAD``, the parameters and the EMA shadow after the call within
    ``TOL_STEP``, but for the elements whose first Adam update took the
    other sign (a gradient of 0 up to rounding), at most 1e-4 of them, each
    within twice the update's rate."""
    jcfg = jax_load_config(jax_default_config, TINY)
    jld, jparams = jax_build_pipeline(jcfg, with_alignment=False)
    unet_p = randomize_flax(jparams["unet"], 31)
    vae_p = randomize_flax(jparams["vae"], 32)
    tcfg = load_config(prediff_default_config, TINY)
    ld = build_training_pipeline(tcfg, device="cpu", params={
        "unet": flax_params_to_torch(build_unet(tcfg), unet_p),
        "vae": flax_params_to_torch(build_vae(tcfg), vae_p)})
    xs, ys = _stacks(tcfg, K, seed=3)

    rs = np.random.RandomState(33)
    t = np.array([3, 7], np.int32)
    noise = rs.randn(2, *tcfg.model.diffusion.latent_shape).astype(np.float32)
    eps = {}

    def eps_of(shape):
        if shape not in eps:
            eps[shape] = np.random.RandomState(34).randn(*shape).astype(np.float32)
        return eps[shape]

    monkeypatch.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            eps_of(tuple(self.mean.shape))))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise))

    def injected(self, generator, batch, out):
        got = (eps_of(self.training_draw_shapes(batch)[0]), t, noise)
        for buf, v in zip(out, got):
            buf.copy_(torch.from_numpy(v))
        return out

    monkeypatch.setattr(tld.LatentDiffusion, "training_draws", injected)

    jtr = JaxDiffusionTrainer(jld, vae_p, optim_config=OPTIM)
    jstate = jtr.create_state(unet_p)
    jstate, jmets = jtr.train_step_scan(jstate, jax.random.PRNGKey(0),
                                        jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()))
    jmets = jax.device_get(jmets)

    trainer = DiffusionTrainer(ld, optim_config=OPTIM)
    state = trainer.create_state()
    state, mets = trainer.train_step_scan(state, 0, xs, ys)
    assert state.step == int(jstate.step) == K and state.tx.count == 1
    assert sorted(mets) == sorted(jmets)
    for k in jmets:
        assert tuple(mets[k].shape) == (K,), k
        np.testing.assert_allclose(mets[k].numpy(), np.asarray(jmets[k]), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)
    assert float(mets["grad_norm"].min()) > OPTIM["gradient_clip_val"]   # the clip bites
    want_p = flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(np.asarray, jstate.params))
    want_e = flax_train_tree_to_torch(ld.unet,
                                      jax.tree_util.tree_map(np.asarray, jstate.ema_params))
    start = flax_params_to_torch(build_unet(tcfg), unet_p)
    # Adam's first update is lr * g / (|g| + eps), about lr * sign(g): an element whose
    # gradient is 0 up to the two implementations' rounding may move either way, by up to
    # the update's rate.  Every other element holds TOL_STEP; those few hold that rate.
    rate = OPTIM["lr"] * OPTIM["warmup_min_lr_ratio"]
    flipped = total = 0
    moved = 0.0
    for k, p in state.params.items():
        for got, want in ((p.detach(), want_p[k]), (state.ema_params[k], want_e[k])):
            err = (got - want).abs()
            over = err > TOL_STEP * (1.0 + want.abs())
            flipped += int(over.sum())
            total += err.numel()
            assert float(err.max()) <= 2.0 * rate, (k, float(err.max()))
        if k.startswith("unet."):
            moved = max(moved, float((p.detach() - start[k[len("unet."):]]).abs().max()))
    assert flipped <= 1e-4 * total, (flipped, total)
    assert moved > 1e-5


def _run(cfg, latent: bool, scan: bool, calls: int = 2, **trainer_kw):
    """``calls`` x K micro-steps of a fresh trainer from a fixed seed: by
    ``train_step_scan`` (``scan``) or by as many ``train_step`` calls.
    Returns the state and the metrics stacked over the micro-steps."""
    ld = build_training_pipeline(cfg, device="cpu", seed=4)
    xs, ys = _stacks(cfg, calls * K, seed=5)
    if latent:
        def moments(a):
            m = ld.first_stage_moments(a.reshape((-1,) + tuple(a.shape[2:])))
            return m.reshape(tuple(a.shape[:2]) + tuple(m.shape[1:]))

        with torch.no_grad():
            xs, ys = torch.stack([moments(a) for a in xs]), torch.stack([moments(a) for a in ys])
    trainer = DiffusionTrainer(ld, optim_config=OPTIM, latent_inputs=latent,
                               track_grad_norm=True, **trainer_kw)
    state = trainer.create_state()
    got = []
    if scan:
        for c in range(calls):
            state, m = trainer.train_step_scan(state, 9, xs[c * K:(c + 1) * K],
                                               ys[c * K:(c + 1) * K])
            got.append(m)
        return state, {k: torch.cat([m[k] for m in got]) for k in got[0]}
    for k in range(calls * K):
        state, m = trainer.train_step(state, 9, xs[k], ys[k])
        got.append(m)
    return state, {k: torch.stack([m[k] for m in got]) for k in got[0]}


@pytest.mark.parametrize("variant", ["pixels", "latents", "global_vectors"])
def test_scan_is_k_train_steps_bit_for_bit(variant):
    """Rates 0.1 (the FFN, attention and time-embedding dropouts): two calls
    of K = 3 micro-steps equal six ``train_step`` calls bit for bit: the
    parameters, both Adam moments, the accumulated gradients, the EMA shadow,
    the counters and every metric, the per-module gradient norms too."""
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(RATES)
    if variant == "global_vectors":
        cfg.model.latent_model.update(num_global_vectors=2)
    latent = variant == "latents"
    (a, ma), (b, mb) = (_run(cfg, latent, scan) for scan in (False, True))
    assert (a.step, a.tx.count, a.tx.mini_step) == (b.step, b.tx.count, b.tx.mini_step) == (
        2 * K, K, 0)
    assert sorted(ma) == sorted(mb) and any(k.startswith("grad_norm/") for k in ma)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(p, q) for p, q in zip(a.tensors(), b.tensors()))
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    assert len(set(float(v) for v in ma["train/loss"])) == 2 * K   # new draws every micro-step
