"""VAE-GAN training of the port against the JAX package (CPU, f32 plain on
both sides, tiny sizes as tests/test_training.py's tiny_setup).

The same randomized weights (every leaf, the discriminator's running
statistics too) go through the bridge; the posterior noise is injected on
both sides (``DiagonalGaussianDistribution.sample`` patched), so the steps
compute the same function.  Both packages' ``EmaTrainState.apply_gradients``
record the gradients they are given (the JAX trainer's own jitted step
through ``jax.debug.callback``).  Held at rel 1e-4 of each leaf's scale
(floored at 1e-3 of the tree's largest): every logged term, ``d_weight``, both
states' gradients and the new batch statistics, with BatchNorm and with
ActNorm, at ``disc_start`` 1: the first step runs before it (the GAN terms
weighed 0, ``d_weight`` still computed), the second at it; then the
parameters after the two steps.  Also ``kl`` / ``nll``, the
VAE's ``encode`` / ``decode_with_features`` / ``forward``, LPIPS, the
discriminator's names through the bridge, ActNorm's data-dependent init,
the refusals and ``factory.build_vae_trainer``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

import prediff_tpu.training.optim as jax_optim
import prediff_tpu.training.train_state as jax_train_state
import prediff_tpu.training.vae_trainer as jax_vae_trainer
import prediff_tpu.utils.distributions as jax_dist
from prediff_tpu.models.vae import AutoencoderKL as JaxVAE
from prediff_tpu.training.losses import NLayerDiscriminator as JaxDisc
from prediff_tpu.training.lpips import LPIPS as JaxLPIPS
from prediff_torch.config import ConfigDict, deep_merge, vae_training_default_config
from prediff_torch.factory import build_vae_trainer
from prediff_torch.models.vae import AutoencoderKL
from prediff_torch.training import VAETrainer
from prediff_torch.training import train_state as torch_train_state
from prediff_torch.training.losses import NLayerDiscriminator
from prediff_torch.training.lpips import LPIPS
from prediff_torch.utils import distributions as torch_dist
from prediff_torch.utils.convert import flatten_tree, flax_params_to_torch, flax_train_tree_to_torch

TOL = 1e-4   # of each leaf's own scale: f32 on both sides, sums in another order
# two channels a group at the first level: a GroupNorm right after a conv would
# otherwise make its bias's gradient 0 but for rounding, which Adam turns into a
# full step of either sign
VAE_KW = dict(in_channels=1, out_channels=1, block_out_channels=(4, 8, 8), layers_per_block=1,
              latent_channels=2, norm_num_groups=2)
B, IMG = 4, 8
OPTIM = dict(lr=1e-3, total_num_steps=100, betas=(0.5, 0.9), gradient_clip_val=None,
             lr_scheduler_mode="constant", warmup_percentage=0.0)
LOSS_KW = dict(kl_weight=1e-2, disc_weight=0.5, disc_factor=1.0, disc_loss="hinge",
               logvar_init=0.3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite's
    workers share the CPU, and a thread per core in each of them makes such
    tests tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _close(name, got, want, tol=TOL, floor=1e-30):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


def _close_tree(what, names, got, want):
    """Each leaf within TOL of its own scale, floored at 1e-3 of the tree's.
    Returns the leaves under the floor: a gradient that is 0 but for rounding
    (the attention key bias, which the softmax cancels)."""
    floor = 1e-3 * max(float(np.abs(want[n]).max()) for n in names)
    for name, g in zip(names, got):
        _close(f"{what} {name}", _np(g), want[name].numpy(), floor=floor)
    return {n for n in names if float(np.abs(want[n]).max()) < floor}


def _np(t):
    return t.detach().cpu().numpy()


def _jax_vae():
    return JaxVAE(down_block_types=("DownEncoderBlock2D",) * 3,
                  up_block_types=("UpDecoderBlock2D",) * 3, decoder_subpixel=False, **VAE_KW)


def _batch_stats(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (0.2 * rs.randn(*v.shape) if p[-1].key == "mean"
                      else 1.0 + 0.3 * np.abs(rs.randn(*v.shape))).astype(np.float32), tree)


DISC_START = 1


def _setup(use_actnorm):
    """Both trainers on the same randomized weights, with their states."""
    jvae, jdisc = _jax_vae(), JaxDisc(input_nc=1, ndf=8, n_layers=1, use_actnorm=use_actnorm)
    jtrainer = jax_vae_trainer.VAETrainer(vae=jvae, disc=jdisc, disc_start=DISC_START,
                                          optim_config=OPTIM, **LOSS_KW)
    x0 = jnp.zeros((B, IMG, IMG, 1))
    vae_p = randomize_flax(jax.jit(jvae.init)(jax.random.PRNGKey(0), x0)["params"], 1)
    dvars = jax.jit(jdisc.init)(jax.random.PRNGKey(1), x0)
    disc_p = randomize_flax(dvars["params"], 2)
    stats = _batch_stats(dvars["batch_stats"], 3) if "batch_stats" in dvars else {}
    gen = jax_train_state.EmaTrainState.create(
        {"vae": vae_p, "logvar": jnp.asarray(LOSS_KW["logvar_init"], jnp.float32)},
        jax_optim.build_optimizer(**OPTIM), use_ema=False)
    disc = jax_train_state.EmaTrainState.create(disc_p, jax_optim.build_optimizer(**OPTIM),
                                                use_ema=False)

    tvae = AutoencoderKL(**VAE_KW)
    tvae.load_state_dict(flax_params_to_torch(tvae, vae_p))
    tdisc = NLayerDiscriminator(input_nc=1, ndf=8, n_layers=1, use_actnorm=use_actnorm)
    tdisc.load_state_dict(flax_params_to_torch(tdisc, disc_p, stats))
    ttrainer = VAETrainer(tvae, tdisc, disc_start=DISC_START, optim_config=OPTIM, **LOSS_KW)
    return (jtrainer, gen, disc, stats), (ttrainer, *ttrainer.create_states())


@pytest.fixture
def injected(monkeypatch):
    """The posterior noise on both sides (one array: the jitted JAX step
    bakes it in when it traces); the gradients each state is given."""
    eps = np.random.RandomState(7).randn(B, 2, 2, 2).astype(np.float32)
    recorded = {"jax_gen": [], "jax_disc": [], "torch": []}

    def jax_sample(self, rng):
        return self.mean + self.std * jnp.asarray(eps)

    def torch_sample(self, generator=None):
        return self.mean + self.std * torch.from_numpy(eps)

    monkeypatch.setattr(jax_dist.DiagonalGaussianDistribution, "sample", jax_sample)
    monkeypatch.setattr(torch_dist.DiagonalGaussianDistribution, "sample", torch_sample)
    jax_apply = jax_train_state.EmaTrainState.apply_gradients
    torch_apply = torch_train_state.EmaTrainState.apply_gradients

    def jax_record(self, grads):
        key = "jax_gen" if "logvar" in grads else "jax_disc"
        jax.debug.callback(lambda g: recorded[key].append(jax.tree_util.tree_map(np.asarray, g)),
                           grads)
        return jax_apply(self, grads)

    def torch_record(self, grads):
        recorded["torch"].append([g.clone() for g in grads])
        return torch_apply(self, grads)

    monkeypatch.setattr(jax_train_state.EmaTrainState, "apply_gradients", jax_record)
    monkeypatch.setattr(torch_train_state.EmaTrainState, "apply_gradients", torch_record)
    return recorded


def _stats_of(stats):
    """The flax batch statistics under the port's buffer names."""
    return {f"main.{path[0].split('_')[1]}.running_{path[1]}": v
            for path, v in flatten_tree(stats).items()}


@pytest.mark.parametrize("use_actnorm", [False, True], ids=["batchnorm", "actnorm"])
def test_two_steps_match_the_jax_trainer(injected, use_actnorm):
    (jtrainer, gen, disc, stats), (ttrainer, tgen, tdisc_state, tstats) = _setup(use_actnorm)
    x = np.random.RandomState(5).rand(B, IMG, IMG, 1).astype(np.float32)
    tdisc = ttrainer.disc
    rounding = set()
    for step in range(2):
        gen, disc, stats, jlogs = jtrainer.train_step(gen, disc, stats, jax.random.PRNGKey(1),
                                                      jnp.asarray(x))
        tgen, tdisc_state, tstats, tlogs = ttrainer.train_step(tgen, tdisc_state, tstats, 1,
                                                               torch.from_numpy(x))
        assert set(tlogs) == set(jlogs)
        for k in jlogs:
            _close(f"step {step} {k}", _np(tlogs[k]), jlogs[k])
        assert float(tlogs["train/disc_factor"]) == float(step >= DISC_START)
        assert float(tlogs["train/d_weight"]) > 0        # computed before disc_start too
        tg_gen, tg_disc = injected["torch"][2 * step:2 * step + 2]
        want = flax_train_tree_to_torch(ttrainer.vae, injected["jax_gen"][step], name="vae")
        assert set(tgen.params) == set(want)
        rounding |= _close_tree(f"step {step} gen grad", list(tgen.params), tg_gen, want)
        want = flax_params_to_torch(tdisc, injected["jax_disc"][step], stats)
        if step >= DISC_START:
            rounding |= _close_tree(f"step {step} disc grad", list(tdisc_state.params), tg_disc,
                                    want)
        else:
            assert not any(want[n].any() for n in tdisc_state.params)
            assert not any(g.any() for g in tg_disc)
        for name, v in _stats_of(stats).items():
            _close(f"step {step} {name}", _np(tstats[name]), v)
    # the parameters after two steps.  Adam turns a gradient that is 0 but for
    # rounding into a step of about lr of either sign: those leaves (the attention
    # key biases, which the softmax cancels; the last conv's bias in the
    # discriminator when every logit lies inside the hinge's margin) within 2 x 2 lr
    assert len(rounding) <= 3, rounding
    want = {**flax_train_tree_to_torch(ttrainer.vae, gen.params, name="vae"),
            **flax_params_to_torch(tdisc, disc.params, stats)}
    for name, p in [*tgen.params.items(), *tdisc_state.params.items()]:
        if name in rounding:
            assert float((p.detach() - want[name]).abs().max()) <= 4 * OPTIM["lr"], name
        else:
            _close(f"param {name}", _np(p), want[name].numpy())
    assert tgen.step == tdisc_state.step == 2 and tgen.tx.count == 2


@pytest.mark.parametrize("with_other", [False, True])
def test_kl_and_nll_match_jax(with_other):
    rs = np.random.RandomState(0)
    a, b = (rs.randn(3, 4, 4, 6).astype(np.float32) for _ in range(2))
    s = rs.randn(3, 4, 4, 3).astype(np.float32)
    ja, jb = (jax_dist.DiagonalGaussianDistribution.from_parameters(jnp.asarray(v)) for v in (a, b))
    ta, tb = (torch_dist.DiagonalGaussianDistribution.from_parameters(torch.from_numpy(v))
              for v in (a, b))
    _close("kl", _np(ta.kl(tb if with_other else None)), ja.kl(jb if with_other else None))
    _close("nll", _np(ta.nll(torch.from_numpy(s))), ja.nll(jnp.asarray(s)))
    assert _np(ta.kl()).shape == (3,)


def test_vae_encode_decode_with_features_and_forward_match_jax():
    jvae = _jax_vae()
    x = np.random.RandomState(1).randn(2, IMG, IMG, 1).astype(np.float32)
    params = randomize_flax(jax.jit(jvae.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 4)
    tvae = AutoencoderKL(**VAE_KW)
    tvae.load_state_dict(flax_params_to_torch(tvae, params))
    v = {"params": params}
    with torch.no_grad():
        post = tvae.encode(torch.from_numpy(x))
        jpost = jax.jit(partial(jvae.apply, method=JaxVAE.encode))(v, jnp.asarray(x))
        _close("mean", _np(post.mean), jpost.mean)
        _close("logvar", _np(post.logvar), jpost.logvar)
        z = np.random.RandomState(2).randn(2, 2, 2, 2).astype(np.float32)
        rec, feats = tvae.decode_with_features(torch.from_numpy(z))
        jrec, jfeats = jax.jit(partial(jvae.apply, method=JaxVAE.decode_with_features))(
            v, jnp.asarray(z))
        _close("recon", _np(rec), jrec)
        _close("features", _np(feats), jfeats)
        assert feats.shape == (2, IMG, IMG, 4)
        dec, _ = tvae(torch.from_numpy(x))              # the posterior mode
        jdec, _ = jax.jit(jvae.apply)(v, jnp.asarray(x))
        _close("forward", _np(dec), jdec)
        g = torch.Generator().manual_seed(3)
        sampled, _ = tvae(torch.from_numpy(x), sample_posterior=True, generator=g)
        assert not torch.equal(sampled, dec)


def test_lpips_matches_jax_with_seeded_weights():
    jl = JaxLPIPS()
    rs = np.random.RandomState(0)
    a, b = (rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32) for _ in range(2))
    params = randomize_flax(jax.jit(jl.init)(jax.random.PRNGKey(0), jnp.asarray(a),
                                             jnp.asarray(b))["params"], 5)
    tl = LPIPS().eval()
    tl.load_state_dict(flax_params_to_torch(tl, params))
    with torch.no_grad():
        got = tl(torch.from_numpy(a), torch.from_numpy(b))
        same = tl(torch.from_numpy(a), torch.from_numpy(a))
    want = jax.jit(jl.apply)({"params": params}, jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (2, 1, 1, 1)
    _close("lpips", _np(got), want)
    assert float(same.abs().max()) == 0.0


@pytest.mark.parametrize("use_actnorm", [False, True], ids=["batchnorm", "actnorm"])
def test_discriminator_names_map_through_the_bridge(use_actnorm):
    """Every leaf once both ways: flax main_{i} kernels, BatchNorm scale /
    bias and batch_stats mean / var, ActNorm's NHWC loc / scale."""
    jd = JaxDisc(input_nc=1, ndf=8, n_layers=3, use_actnorm=use_actnorm)
    x = jnp.zeros((2, 64, 64, 1))
    variables = jax.jit(jd.init)(jax.random.PRNGKey(0), x)
    params = randomize_flax(variables["params"], 6)
    stats = _batch_stats(variables["batch_stats"], 7) if "batch_stats" in variables else None
    td = NLayerDiscriminator(input_nc=1, ndf=8, n_layers=3, use_actnorm=use_actnorm)
    sd = flax_params_to_torch(td, params, stats)
    td.load_state_dict(sd)
    keys = [k for k in sd if "num_batches" not in k]
    assert len(keys) == len(flatten_tree(params)) + (len(flatten_tree(stats)) if stats else 0)
    assert [k.split(".")[1] for k in keys if k.endswith("weight") and sd[k].ndim == 4] == \
        ["0", "2", "5", "8", "11"]
    if use_actnorm:
        assert sd["main.3.loc"].shape == (1, 16, 1, 1)
        np.testing.assert_array_equal(sd["main.3.scale"].numpy()[0, :, 0, 0],
                                      np.asarray(params["main_3"]["scale"])[0, 0, 0])
        assert td.batch_stats() == {}
    else:
        np.testing.assert_array_equal(sd["main.3.running_var"].numpy(),
                                      np.asarray(stats["main_3"]["var"]))
        assert set(td.batch_stats()) == {f"main.{i}.running_{s}" for i in (3, 6, 9)
                                         for s in ("mean", "var")}
    with pytest.raises(ValueError, match="maps to 0 flax leaves"):
        if use_actnorm:
            bad = dict(params)
            bad.pop("main_3")
            flax_params_to_torch(td, bad)
        else:
            flax_params_to_torch(td, params)   # the running statistics are missing
    # eval mode normalises by the running statistics: the same logits as flax
    xin = np.random.RandomState(8).randn(2, 64, 64, 1).astype(np.float32)
    v = {"params": params, **({"batch_stats": stats} if stats else {})}
    with torch.no_grad():
        _close("eval logits", _np(td(torch.from_numpy(xin))),
               jax.jit(jd.apply)(v, jnp.asarray(xin)))


def test_actnorm_data_init_matches_flax_init():
    """ActNorm's loc and scale from the first batch as it reaches each layer."""
    jd = JaxDisc(input_nc=1, ndf=8, n_layers=2, use_actnorm=True)
    x = (np.random.RandomState(9).randn(3, 32, 32, 1) * 2 + 0.5).astype(np.float32)
    params = jax.jit(jd.init)(jax.random.PRNGKey(4), jnp.asarray(x))["params"]
    td = NLayerDiscriminator(input_nc=1, ndf=8, n_layers=2, use_actnorm=True)
    td.load_state_dict(flax_params_to_torch(td, params))
    for name in ("main.3", "main.6"):
        td.get_submodule(name).loc.data.zero_()
        td.get_submodule(name).scale.data.fill_(1.0)
    td.data_init(torch.from_numpy(x))
    want = flax_params_to_torch(td, params)
    for name in ("main.3.loc", "main.3.scale", "main.6.loc", "main.6.scale"):
        _close(name, _np(td.state_dict()[name]), want[name].numpy())
    td.data_init(torch.zeros(3, 32, 32, 1))           # a constant batch: the identity
    assert torch.equal(td.main[3].scale, torch.ones_like(td.main[3].scale))


def _tiny_cfg():
    cfg = vae_training_default_config()
    return ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "vae": dict(block_out_channels=[4, 8, 8], layers_per_block=1, latent_channels=2,
                    norm_num_groups=4),
        "loss": dict(disc_num_layers=1)}}))


def test_refusals_and_build_vae_trainer_from_config():
    cfg = _tiny_cfg()
    trainer = build_vae_trainer(cfg, device="cpu", seed=3)
    assert trainer.disc_start == 50001 and trainer.kl_weight == 1e-6
    assert len([m for m in trainer.disc.main if isinstance(m, torch.nn.Conv2d)]) == 3
    gen, disc, stats = trainer.create_states()
    for state, lr in ((gen, cfg.optim.lr), (disc, cfg.optim.lr)):
        group = state.tx.optimizer.param_groups[0]
        assert group["betas"] == (0.5, 0.9) and state.tx.gradient_clip_val is None
        assert state.tx.schedule(1) == state.tx.schedule(1000) == lr
    assert "logvar" in gen.params and float(gen.params["logvar"].detach()) == 0.0
    assert set(stats) == {"main.3.running_mean", "main.3.running_var"}
    x = torch.rand(2, IMG, IMG, 1, generator=torch.Generator().manual_seed(0))
    gen, disc, stats, logs = trainer.train_step(gen, disc, stats, 0, x)
    assert all(torch.isfinite(v) for v in logs.values())
    assert gen.step == disc.step == 1

    vae = AutoencoderKL(**VAE_KW)
    assert VAETrainer(vae, compute_dtype="bfloat16").compute_dtype == torch.bfloat16
    assert VAETrainer(vae, compute_dtype="auto").compute_dtype is None   # f32 off a TPU, as in JAX
    with pytest.raises(ValueError, match="compute_dtype"):
        VAETrainer(vae, compute_dtype="int8")
    # the mesh is taken (DDP training; two ranks in tests/test_torch_ddp_training.py)
    from prediff_torch.parallel import make_mesh
    assert VAETrainer(vae, mesh=make_mesh(device="cpu")).mesh.size == 1
    for knob, value in (("flat_update", True), ("pack_small_thr", 4096)):
        with pytest.raises(NotImplementedError, match=knob):
            VAETrainer(vae, **{knob: value})
    with pytest.raises(TypeError, match="unexpected"):
        VAETrainer(vae, remat=True)
    cfg.optim.vae_compute_dtype = "bfloat16"
    assert build_vae_trainer(cfg, device="cpu").compute_dtype == torch.bfloat16
