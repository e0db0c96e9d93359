"""Knowledge-alignment training of the port against the JAX package (CPU, f32
plain on both sides, tiny sizes as tests/test_training.py's tiny_setup: an
axial alignment net of base_units 8 and depth [1] over the latents of a
(4, 8, 8) VAE on 8x16 frames: 3x2x4, so that an axial layer's length names
its axis).

The same randomized weights go through the bridge.  The draws are injected
on both sides: the posterior noise (``DiagonalGaussianDistribution.sample``
patched), t and the q-sample noise (``jax.random.randint`` / ``normal``
patched in the JAX loss, ``AlignmentTrainer._draw`` in the port's), and at
rate 0.1 the dropout masks: the port draws its own (Philox, from the step's
dropout seed) and each ``flax.linen.Dropout`` call of the JAX forward takes
the mask the port drew at the same site, as ``test_torch_dropout.py`` does
for the UNet.  Held at rel 1e-4 (each leaf's gradient of its own scale,
floored at 1e-3 of the tree's): the loss, its ``loss_dict`` and every
gradient, with pixel inputs and with cached moments (``latent_inputs``), l2
and l1.  Also the trainer's own steps (repeatable from a seed, dropout
active), the refusals, ``factory.build_alignment_trainer`` and the guided
step under cuDNN's deterministic algorithms.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax
from test_torch_vae_trainer import _close, _close_tree, _np

import prediff_tpu.utils.distributions as jax_dist
from prediff_tpu.models.alignment import NoisyCuboidTransformerEncoder as JaxEncoder
from prediff_tpu.models.vae import AutoencoderKL as JaxVAE
from prediff_tpu.training.alignment_trainer import AlignmentTrainer as JaxAlignmentTrainer
import prediff_torch.models.layers as tlayers
from prediff_torch.config import ConfigDict, alignment_default_config, deep_merge
from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
from prediff_torch.factory import build_alignment_trainer
from prediff_torch.models.alignment import NoisyCuboidTransformerEncoder
from prediff_torch.models.vae import AutoencoderKL
from prediff_torch.ops import dropout
from prediff_torch.ops.attention import axial_cuboid_size
from prediff_torch.ops.cuboid import cuboid_reorder
from prediff_torch.training import AlignmentTrainer
from prediff_torch.utils import distributions as torch_dist
from prediff_torch.utils.convert import flax_params_to_torch
from prediff_torch.utils.device import resolve_device

VAE_KW = dict(in_channels=1, out_channels=1, block_out_channels=(4, 8, 8), layers_per_block=1,
              latent_channels=2, norm_num_groups=2)
NET_KW = dict(input_shape=(3, 2, 4, 2), out_channels=1, base_units=8, depth=[1], downsample=2,
              block_attn_patterns="axial", num_heads=2, padding_type="zeros", out_len=3)
B, T, H, W, STEPS, SCALE = 2, 3, 8, 16, 10, 0.7
DROP_SEED = 0x5EED_A11C


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite's
    workers share the CPU, and a thread per core in each of them makes such
    tests tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _nets(rate):
    rates = dict(attn_drop=rate, proj_drop=rate, ffn_drop=rate)
    jnet = JaxEncoder(ffn_activation="gelu", readout_seq=True, **rates, **NET_KW)
    jvae = JaxVAE(down_block_types=("DownEncoderBlock2D",) * 3,
                  up_block_types=("UpDecoderBlock2D",) * 3, decoder_subpixel=False, **VAE_KW)
    z0 = jnp.zeros((B,) + NET_KW["input_shape"])
    net_p = randomize_flax(jax.jit(jnet.init)(jax.random.PRNGKey(0), z0,
                                              jnp.zeros((B,), jnp.int32))["params"], 1)
    vae_p = randomize_flax(jax.jit(jvae.init)(jax.random.PRNGKey(1),
                                              jnp.zeros((1, H, W, 1)))["params"], 2)
    tnet = NoisyCuboidTransformerEncoder(**rates, **NET_KW)
    tnet.load_state_dict(flax_params_to_torch(tnet, net_p))
    tvae = AutoencoderKL(**VAE_KW)
    tvae.load_state_dict(flax_params_to_torch(tvae, vae_p))
    return (jnet, jvae, net_p, vae_p), (tnet, tvae.eval().requires_grad_(False))


def _inject_draws(monkeypatch, trainer, t, noise, eps):
    monkeypatch.setattr(jax_dist.DiagonalGaussianDistribution, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(eps))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(t))
    monkeypatch.setattr(jax.random, "normal", lambda *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(torch_dist.DiagonalGaussianDistribution, "sample",
                        lambda self, generator=None: self.mean + self.std * torch.from_numpy(eps))
    monkeypatch.setattr(trainer, "_draw", lambda generator, z: (torch.from_numpy(t).long(),
                                                                torch.from_numpy(noise)))


def _record_masks(monkeypatch, fn):
    """The port's masks of ``fn()``, in draw order: (shape, rate, mask)."""
    drawn = []
    real = dropout.keep_mask

    def recording(seed, site, tensor, shape, rate, device=None):
        mask = real(seed, site, tensor, shape, rate, device)
        drawn.append((tuple(shape), rate, mask.numpy()))
        return mask

    monkeypatch.setattr(dropout, "keep_mask", recording)
    monkeypatch.setattr(tlayers, "keep_mask", recording)
    fn()
    monkeypatch.setattr(dropout, "keep_mask", real)
    monkeypatch.setattr(tlayers, "keep_mask", real)
    return drawn


def _inject_masks(monkeypatch, pending):
    """Each flax Dropout call takes the next mask the port drew (the attention
    output's natural (B, T, H, W, C) mask reordered into flax's cuboids)."""
    def injected(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic, deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        shape, rate, mask = pending.pop(0)
        assert rate == self.rate
        if mask.size != inputs.size:
            raise AssertionError(f"site order differs: flax drops {inputs.shape}, the port {shape}")
        if mask.ndim == 5 and inputs.ndim == 4:
            _, _, vol, _ = inputs.shape
            axes = [a for a in range(3) if shape[1:4][a] == vol]
            mask = cuboid_reorder(torch.from_numpy(mask), axial_cuboid_size(shape, axes[0]),
                                  ("l", "l", "l")).numpy()
        return inputs * jnp.asarray(mask.reshape(inputs.shape)) / (1.0 - self.rate)

    monkeypatch.setattr(fnn.Dropout, "__call__", injected)


CASES = [(0.0, False, "l2"), (0.0, True, "l1"), (0.1, False, "l2"), (0.1, True, "l2")]


@pytest.mark.parametrize("rate,latent,loss_type", CASES,
                         ids=["rate0-pixels-l2", "rate0-latents-l1", "rate0.1-pixels-l2",
                              "rate0.1-latents-l2"])
def test_loss_and_every_gradient_match_the_jax_trainer(monkeypatch, rate, latent, loss_type):
    (jnet, jvae, net_p, vae_p), (tnet, tvae) = _nets(rate)
    rs = np.random.RandomState(3)
    if latent:   # cached moments windows and the cached per-frame pixel means
        x, y = (rs.randn(B, T, 2, 4, 4).astype(np.float32) for _ in range(2))
        target = rs.rand(B, T, 1).astype(np.float32)
    else:
        x, y = (rs.rand(B, T, H, W, 1).astype(np.float32) for _ in range(2))
        target = None
    t = np.array([3, 8], np.int32)
    noise = rs.randn(B, *NET_KW["input_shape"]).astype(np.float32)
    eps = rs.randn(B * T, 2, 4, 2).astype(np.float32)

    ttr = AlignmentTrainer(tnet, tvae, timesteps=STEPS, scale_factor=SCALE, loss_type=loss_type,
                           latent_inputs=latent)
    state = ttr.create_state()
    jtr = JaxAlignmentTrainer(
        model_apply=jnet.apply, vae_params=vae_p, timesteps=STEPS, scale_factor=SCALE,
        loss_type=loss_type, latent_inputs=latent,
        vae_apply_encode=lambda v, f: jvae.apply(v, f, method=JaxVAE.encode_moments))
    _inject_draws(monkeypatch, ttr, t, noise, eps)
    tgt = None if target is None else torch.from_numpy(target)

    def port_loss():
        return ttr.loss_fn(None, torch.from_numpy(x), torch.from_numpy(y), tgt,
                           dropout_seed=DROP_SEED)

    if rate > 0:
        with torch.no_grad():
            pending = _record_masks(monkeypatch, port_loss)
        # first_proj, then 3 x (attention: weights and output; FFN: hidden and output)
        assert len(pending) == 1 + 3 * 4
        _inject_masks(monkeypatch, pending)
    loss, loss_dict = port_loss()
    grads = torch.autograd.grad(loss, list(state.params.values()))

    jtgt = None if target is None else jnp.asarray(target)
    (jloss, jdict), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jax.random.PRNGKey(5), jnp.asarray(x), jnp.asarray(y),
                              train=True, target=jtgt), has_aux=True))(net_p)
    if rate > 0:
        assert not pending                          # every mask taken once
    _close("loss", _np(loss), jloss)
    for k in jdict:
        _close(k, _np(loss_dict[k]), jdict[k])
    want = flax_params_to_torch(tnet, jgrads)
    assert set(state.params) == set(want)
    _close_tree("grad", list(state.params), grads, want)
    assert sum(float(g.abs().max()) > 0 for g in grads) >= len(grads) - 4


def _tiny_cfg(**rates):
    cfg = alignment_default_config()
    return ConfigDict.wrap(deep_merge(cfg.to_dict(), {
        "layout": dict(in_len=2, out_len=T, img_height=H, img_width=W),
        "model": {"vae": {k: list(v) if isinstance(v, tuple) else v for k, v in VAE_KW.items()},
                  "align": {"model_args": dict(
                      input_shape=list(NET_KW["input_shape"]), base_units=8, depth=[1],
                      num_heads=2, out_len=T, **rates)},
                  "diffusion": dict(timesteps=STEPS, scale_factor=SCALE)}}))


def test_trainer_steps_repeat_from_a_seed_with_dropout_active():
    """build_alignment_trainer on a tiny alignment config at the recipe's rates
    (0.1): micro-steps from one seed repeat bit for bit, two micro-steps draw
    different masks, the network is trained, the VAE is not."""
    cfg = _tiny_cfg()
    assert cfg.model.align.model_args.attn_drop == 0.1
    rs = np.random.RandomState(0)
    x, y = (torch.from_numpy(rs.rand(B, T, H, W, 1).astype(np.float32)) for _ in range(2))
    runs = []
    for _ in range(2):
        trainer = build_alignment_trainer(cfg, device="cpu", seed=4)
        assert trainer.model.training and not trainer.vae.training
        assert not any(p.requires_grad for p in trainer.vae.parameters())
        state = trainer.create_state()
        group = state.tx.optimizer.param_groups[0]
        assert group["betas"] == (0.9, 0.999) and state.tx.gradient_clip_val == 1.0
        before = {k: p.detach().clone() for k, p in state.params.items()}
        losses = []
        for _ in range(2):
            state, metrics = trainer.train_step(state, 7, x, y)
            losses.append(float(metrics["train_loss"]))
        assert state.step == 2 and all(np.isfinite(losses))
        assert any(not torch.equal(before[k], p) for k, p in state.params.items())
        runs.append((losses, {k: p.detach().clone() for k, p in state.params.items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])
    # the same draws with other masks: the dropout is active in training mode
    gen = torch.Generator().manual_seed(1)
    a, _ = trainer.loss_fn(gen, x, y, dropout_seed=1)
    gen = torch.Generator().manual_seed(1)
    b, _ = trainer.loss_fn(gen, x, y, dropout_seed=2)
    assert float(a.detach()) != float(b.detach())
    with pytest.raises(ValueError, match="dropout_seed"):
        trainer.loss_fn(torch.Generator().manual_seed(1), x, y)


def test_refusals():
    cfg = _tiny_cfg()
    trainer = build_alignment_trainer(cfg, device="cpu")    # prng_impl / conv3d_impl "auto"
    net, vae = trainer.model, trainer.vae
    # the mesh is taken (DDP training; two ranks in tests/test_torch_ddp_training.py)
    from prediff_torch.parallel import make_mesh
    assert AlignmentTrainer(net, vae, mesh=make_mesh(device="cpu")).mesh.size == 1
    for knob, value in (("prng_impl", "rbg"), ("flat_update", True),
                        ("pack_small_thr", 4096), ("matmul_precision", "bfloat16"),
                        ("conv3d_impl", "xla")):
        with pytest.raises(NotImplementedError, match=knob):
            AlignmentTrainer(net, vae, **{knob: value})
    with pytest.raises(TypeError, match="unexpected"):
        AlignmentTrainer(net, vae, remat=True)
    with pytest.raises(ValueError, match="frozen"):
        AlignmentTrainer(net, vae.requires_grad_(True))
    with pytest.raises(ValueError, match="cached target"):
        AlignmentTrainer(net, vae.requires_grad_(False), latent_inputs=True).loss_fn(
            None, torch.zeros(B, T, 2, 4, 4), torch.zeros(B, T, 2, 4, 4), dropout_seed=1)


def test_guided_step_runs_with_cudnn_deterministic(monkeypatch):
    """The card's entry points (``resolve_device``) switch cuDNN to its
    deterministic algorithms before anything is captured, so every guidance
    shift, eager or in a graph, runs with them; probed on get_mean_shift."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    resolve_device("cpu")
    assert not torch.backends.cudnn.deterministic          # the CPU path sets nothing
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None).type == "cuda"
    net = NoisyCuboidTransformerEncoder(**NET_KW).eval().requires_grad_(False)
    seen = []
    forward = net.forward

    def probe(*args, **kwargs):
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(net, "forward", probe)
    shift = KnowledgeAlignment(net, guide_scale=2.0).get_mean_shift(
        torch.randn((1,) + NET_KW["input_shape"]), torch.tensor([3]), torch.tensor([[0.4]]))
    assert torch.isfinite(shift).all()
    assert seen == [(True, False, False)]
