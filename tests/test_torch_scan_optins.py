"""K diffusion micro-steps per call (``DiffusionTrainer.train_step_scan``)
with the trainer's opt-ins on the CPU: ``remat_unet``, Adam moments stored
in bf16 (``state_dtype``), a bf16 EMA shadow (``ema_dtype``), all three at
once and an f32 ``ema_dtype``, each bit-equal to K calls of ``train_step`` at
the recipe's rates 0.1 (the captured micro-step's code, run eagerly: the
draws injected from buffers, the dropout seed on the device, the train
state's device scalars, ``AdamStateDtype``'s among them); and the bf16
moments and shadow against the JAX trainer's ``train_step_scan`` with the
same opt-ins at rates 0, the draws injected on both sides, at the bars of
``tests/test_torch_scan_trainer.py``'s comparison, the stored bf16 values
within one bf16 ulp of JAX's as ``tests/test_torch_trainer_optins.py``
holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scan_trainer import K, OPTIM, RATES, TINY, _stacks
from test_torch_trainer_optins import _bf16_ulp, _jax_moments
from test_torch_training import TOL_GRAD, TOL_STEP
from test_torch_unet import randomize_flax

import prediff_tpu.utils.distributions as jax_dist
import prediff_torch.diffusion.latent_diffusion as tld
from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.training.diffusion_trainer import DiffusionTrainer as JaxDiffusionTrainer
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_training_pipeline, build_unet, build_vae
from prediff_torch.training import DiffusionTrainer
from prediff_torch.utils.convert import flax_params_to_torch, flax_train_tree_to_torch

OPTINS = {"remat": dict(remat_unet=True),
          "bf16_moments": dict(state_dtype="bfloat16"),
          "bf16_shadow": dict(ema_dtype="bfloat16"),
          "all_three": dict(remat_unet=True, state_dtype="bfloat16", ema_dtype="bfloat16"),
          "f32_shadow": dict(ema_dtype="float32")}


def _trainer(cfg, **kw):
    ld = build_training_pipeline(cfg, device="cpu", seed=4)
    sdtype = kw.pop("state_dtype", None)
    return DiffusionTrainer(ld, optim_config=dict(OPTIM, state_dtype=sdtype),
                            track_grad_norm=True, **kw)


@pytest.mark.parametrize("optin", sorted(OPTINS))
def test_scan_with_an_optin_is_k_train_steps_bit_for_bit(optin):
    """Rates 0.1, pixels: one call of K = 3 micro-steps (accumulate, update,
    accumulate) equals three ``train_step`` calls bit for bit: the parameters, both
    Adam moments in their stored dtype and their update count, the
    accumulated gradients, the EMA shadow in its dtype, the counters and
    every metric; mismatched stacks raise ``ValueError``."""
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(RATES)
    xs, ys = _stacks(cfg, K, seed=5)
    eager, scan = _trainer(cfg, **OPTINS[optin]), _trainer(cfg, **OPTINS[optin])
    a, b = eager.create_state(), scan.create_state()
    want = []
    for k in range(K):
        a, m = eager.train_step(a, 9, xs[k], ys[k])
        want.append(m)
    b, got = scan.train_step_scan(b, 9, xs, ys)
    want = {k: torch.stack([m[k] for m in want]) for k in want[0]}
    assert a.counters() == b.counters() and b.tx.count == 1 and b.step == K
    assert sorted(want) == sorted(got) and all(torch.equal(want[k], got[k]) for k in want)
    assert all(p.dtype == q.dtype and torch.equal(p, q) for p, q in zip(a.tensors(), b.tensors()))
    dtypes = {t.dtype for t in b.tensors()}
    low = "bfloat16" in (OPTINS[optin].get("state_dtype"), OPTINS[optin].get("ema_dtype"))
    assert (torch.bfloat16 in dtypes) == low
    assert len(set(float(v) for v in got["train/loss"])) == K
    assert scan.scan_graphs is not None
    with pytest.raises(ValueError):
        scan.train_step_scan(b, 9, xs[:K], ys[:1])


def test_bf16_state_scan_matches_the_jax_train_step_scan(monkeypatch):
    """Rates 0: one call of K = 3 micro-steps with the Adam moments and the
    EMA shadow stored in bf16 against the JAX trainer's ``train_step_scan``
    with ``state_dtype`` and ``ema_dtype`` bf16, from the same weights, t,
    the noise and the posterior's noise injected on both sides: the stacked
    metrics within ``TOL_GRAD``, the parameters within ``TOL_STEP`` but for
    the elements whose first Adam update took the other sign (a gradient of 0
    up to rounding; at most 1e-4 of them, each within twice the update's
    rate), the stored shadow within one bf16 ulp of JAX's (of the larger,
    plus 1e-6 of the leaf's largest value; a flipped element within that plus
    twice the rate, counted with the parameters'), the stored moments within
    one bf16 ulp plus ``TOL_GRAD`` of the tree's largest moment."""
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
    optim = dict(OPTIM, state_dtype="bfloat16")
    jtr = JaxDiffusionTrainer(jld, vae_p, optim_config=optim, ema_dtype="bfloat16")
    jstate = jtr.create_state(unet_p)
    jstate, jmets = jtr.train_step_scan(jstate, jax.random.PRNGKey(0),
                                        jnp.asarray(xs.numpy()), jnp.asarray(ys.numpy()))
    jmets = jax.device_get(jmets)

    trainer = DiffusionTrainer(ld, optim_config=optim, ema_dtype="bfloat16")
    state = trainer.create_state()
    state, mets = trainer.train_step_scan(state, 0, xs, ys)
    assert state.step == int(jstate.step) == K and state.tx.count == 1
    assert sorted(mets) == sorted(jmets)
    for k in jmets:
        np.testing.assert_allclose(mets[k].numpy(), np.asarray(jmets[k]), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=k)

    def tree(t):
        return flax_train_tree_to_torch(ld.unet, jax.tree_util.tree_map(
            lambda a: np.asarray(a.astype(jnp.float32)), t))

    want_p, want_e = tree(jstate.params), tree(jstate.ema_params)
    mu, nu = _jax_moments(jstate)
    want_m = {"exp_avg": tree(mu), "exp_avg_sq": tree(nu)}
    rate = OPTIM["lr"] * OPTIM["warmup_min_lr_ratio"]
    # a moment's f32 value moves as its gradient does: within TOL_GRAD of the
    # largest moment of the tree (the gradients' bar); leaves whose gradient is 0
    # up to rounding (the time embedding's, cancelled by GroupNorm) hold only that
    largest = {n: max(float(w.abs().max()) for w in want_m[n].values()) for n in want_m}
    flipped = total = 0
    st = state.tx.optimizer.state
    for k, p in state.params.items():
        err = (p.detach() - want_p[k]).abs()
        flipped += int((err > TOL_STEP * (1.0 + want_p[k].abs())).sum())
        total += err.numel()
        assert float(err.max()) <= 2.0 * rate, (k, float(err.max()))
        got_e, want = state.ema_params[k], want_e[k]
        assert got_e.dtype == torch.bfloat16, k
        over = (got_e.float() - want).abs() - _ulp_bar(got_e.float(), want)
        flipped += int((over > 0).sum())
        assert float(over.max()) <= 2.0 * rate, ("ema", k, float(over.max()))
        for n, w in want_m.items():
            got = st[p][n]
            assert got.dtype == torch.bfloat16, (n, k)
            over = (got.float() - w[k]).abs() - _ulp_bar(got.float(), w[k])
            assert float(over.max()) <= TOL_GRAD * largest[n], (n, k, float(over.max()))
    assert flipped <= 1e-4 * total, (flipped, total)


def _ulp_bar(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of the larger, plus 1e-6 of the leaf's largest value
    (``tests/test_torch_trainer_optins.py``'s bar)."""
    return _bf16_ulp(torch.maximum(got.abs(), want.abs())) + 1e-6 * float(want.abs().max())
