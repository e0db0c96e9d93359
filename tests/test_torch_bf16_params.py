"""Forecasts on bf16 parameters (``cast_to_bf16``) held to the JAX package on
configs/tiny_smoke.yaml (CPU), with the same seeded weights: flax leaves from
``jax.eval_shape`` filled by seeded numpy, so no flax init is compiled.

The casts: the weight bridge of JAX's ``cast_to_bf16`` tree is the port's
``cast_to_bf16`` of the f32 bridge, bit for bit; integer buffers stay as they
are; ``cast_to_fp32`` widens exactly; a cast module leaves its original f32.
Loading: ``PreDiffPredictor.from_npz`` of a bf16 ``.npz`` written by the JAX
package's ``save_params_npz`` gives bf16 models; a model whose tensors mix
dtypes raises.  The rule held is flax's promotion: on an f32 carry the bf16
tree is the f32 network on bf16-rounded weights, so the port's chain (4 DDPM
steps; 4 DDIM steps at eta 0; temperature 0, the same x_T) is JAX's
``ld.sample`` on the bf16 trees at the f32 chain tests' bar, and bit-equal
(latent and decode) to the port's f32 pipeline on ``cast_to_fp32`` of the
same tree, whose f32 decode tests/test_torch_chain.py holds to JAX's.

On a bf16 carry the network is bf16 on both sides, and the two round at
other points: flax rounds a dense or conv product before its bias add,
GroupNorm before SiLU and every step of a bf16 softmax, where the port's
fused plain versions (and the kernels they stand for) and torch's bf16 CPU
ops round once, from f32.  So the two bf16 results are two independent
roundings of the f32 function (on the same bf16 weights) and lie about the
sum of their distances to it apart; each is held to JAX's: rel-L2 3e-2 for
one UNet forward, 2e-2 for the chains' latent, 3e-2 for the decoded output,
and the port's distance to the f32 function at most 1.5 times JAX's own bf16
distance to it (measured on a CPU: 0.85 for the forward, 1.15 DDPM, 1.04
DDIM)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.factory import build_vae as jax_build_vae
from prediff_tpu.utils.checkpoint import save_params_npz
from prediff_tpu.utils.precision import cast_to_bf16 as jax_cast_to_bf16
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_alignment_model, build_pipeline, build_unet, build_vae
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.convert import flax_params_to_torch
from prediff_torch.utils.precision import cast_to_bf16, cast_to_fp32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "tiny_smoke.yaml")
F32_TOL = 1e-4            # tests/test_torch_chain.py: f32 on both sides
FORWARD_TOL, LATENT_TOL, DECODED_TOL = 3e-2, 2e-2, 3e-2
ACCURACY_SHARE = 1.5      # |port16 - f32| <= this share of |jax16 - f32|
CHAINS = {"ddpm": dict(timesteps=4), "ddim": dict(timesteps=8, sampler="ddim", ddim_steps=4,
                                                  ddim_eta=0.0)}
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_tree(model, seed, *inputs):
    """The flax parameter tree of ``model`` (shapes by ``jax.eval_shape``),
    every leaf random from ``seed``: norm scales near 1, kernels at
    1/sqrt(fan_in), the rest small."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *inputs))["params"]
    rs = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rs.randn(*leaf.shape)).astype(np.float32)
        if name == "kernel":
            return (rs.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        return (0.1 * rs.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    from prediff_tpu.factory import build_alignment_model as jax_build_alignment

    jcfg = jax_load_config(jax_default_config, TINY)
    d, img = jcfg.model.diffusion, jcfg.layout
    zeros = jnp.zeros
    jparams = {
        "unet": seeded_tree(jax_build_unet(jcfg), 5, zeros((1,) + tuple(d.latent_shape)),
                            zeros((1,), jnp.int32), zeros((1,) + tuple(d.latent_cond_shape))),
        "vae": seeded_tree(jax_build_vae(jcfg), 6,
                           zeros((1, img.img_height, img.img_width, img.data_channels))),
        "align": seeded_tree(jax_build_alignment(jcfg), 7,
                             zeros((1,) + tuple(jcfg.model.align.model_args.input_shape)),
                             zeros((1,), jnp.int32))}
    ld, _ = jax_build_pipeline(jcfg, unet_params=jparams["unet"], vae_params=jparams["vae"],
                               with_alignment=False)
    tcfg = load_config(prediff_default_config, TINY)
    models = {"unet": build_unet(tcfg), "vae": build_vae(tcfg),
              "align": build_alignment_model(tcfg)}
    j16 = jax_cast_to_bf16(jparams)
    state = {k: flax_params_to_torch(m, jparams[k]) for k, m in models.items()}
    state16 = {k: flax_params_to_torch(m, j16[k]) for k, m in models.items()}
    rs = np.random.RandomState(23)
    data = dict(y=rs.rand(2, 3, 32, 32, 1).astype(np.float32),
                x_T=rs.randn(2, *d.latent_shape).astype(np.float32),
                t=np.array([3, 6], np.int32),
                cond=rs.randn(2, *d.latent_cond_shape).astype(np.float32))
    return dict(ld=ld, jparams=jparams, j16=j16, tcfg=tcfg, state=state, state16=state16,
                data=data)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_casts_match_jax_and_keep_integers(setup):
    state, state16 = setup["state"], setup["state16"]
    for key in ("unet", "vae", "align"):
        ours = cast_to_bf16(state[key])
        assert set(ours) == set(state16[key])
        for name, t in state16[key].items():
            assert t.dtype == BF16 and _bits_equal(ours[name], t), (key, name)
        wide = cast_to_fp32(state16[key])
        assert all(_bits_equal(wide[n], t.float()) for n, t in state16[key].items())
    # a module: a cast copy, integer buffers untouched, the original f32
    unet = build_unet(setup["tcfg"])
    unet.load_state_dict(state["unet"])
    low = cast_to_bf16(unet)
    assert low is not unet and all(p.dtype == BF16 for p in low.parameters())
    ints = [(n, b) for n, b in low.named_buffers() if not b.is_floating_point()]
    assert ints and all(b.dtype == torch.int64 for _, b in ints)
    assert all(p.dtype == torch.float32 for p in unet.parameters())
    mixed = {"step": torch.tensor(3), "nested": {"w": torch.zeros(1, dtype=BF16)}}
    out = cast_to_fp32(mixed)
    assert out["step"].dtype == torch.int64 and out["nested"]["w"].dtype == torch.float32


def test_bf16_npz_loads_bf16_and_mixed_dtypes_raise(setup, tmp_path):
    j16 = setup["j16"]
    for key, name in (("unet", "earthformerunet.npz"), ("vae", "vae.npz"),
                      ("align", "alignment.npz")):
        save_params_npz(str(tmp_path / name), j16[key])
    pred = PreDiffPredictor.from_npz(str(tmp_path), setup["tcfg"], device="cpu")
    for key, model in (("unet", pred.ld.unet), ("vae", pred.ld.vae),
                       ("align", pred.ld.alignment.model)):
        got = model.state_dict()
        assert all(_bits_equal(got[n], t) for n, t in setup["state16"][key].items()), key
    mixed = dict(setup["state"]["unet"])
    name = next(iter(mixed))
    mixed[name] = mixed[name].to(BF16)
    with pytest.raises(ValueError, match="dtypes"):
        build_pipeline(setup["tcfg"], device="cpu", params={"unet": mixed})
    with pytest.raises(NotImplementedError, match="f32"):
        build_pipeline(setup["tcfg"], device="cpu", params=setup["state16"],
                       trainable_unet=True)


def test_a_bf16_weight_is_its_own_bf16_layout():
    """``ops/weights``: no second bf16 copy of a bf16 weight, and its cache
    entry does not keep the weight alive; a bf16 vector's f32 copy is exact."""
    import gc
    import weakref

    from prediff_torch.ops import weights

    w = torch.randn(8, 4).to(BF16)
    assert weights.linear_bf16(w).data_ptr() == w.data_ptr()
    assert weights.linear_t_bf16(w).data_ptr() != w.data_ptr()
    assert torch.equal(weights.f32(w[0]), w[0].float())
    ref = weakref.ref(w)
    del w
    gc.collect()
    assert ref() is None


def _jax_sample(setup, params, dtype, decoded, **kw):
    d = setup["data"]
    return setup["ld"].sample(params["unet"], params["vae"], jax.random.PRNGKey(0),
                              jnp.asarray(d["y"]), x_T=jnp.asarray(d["x_T"]), temperature=0.0,
                              compute_dtype=dtype, return_decoded=decoded, **kw)


def _jax_latent(setup, params: str, dtype: str, chain: str):
    """JAX's latent of ``chain``, computed once a module (one compile of each
    static configuration shared by the tests)."""
    key = ("latent", params, dtype, chain)
    if key not in setup:
        setup[key] = _jax_sample(setup, setup[params], dtype, False, **CHAINS[chain])
    return setup[key]


def _jax_decode(setup, latent):
    if "decode" not in setup:
        setup["decode"] = jax.jit(setup["ld"].decode_first_stage)
    return setup["decode"](setup["j16"]["vae"], latent)


def _bf16_rule(got, jax16, jax32, tol):
    """``got`` within ``tol`` (rel-L2) of JAX's bf16 result and no farther from
    the f32 function than ``ACCURACY_SHARE`` times JAX's bf16 result is."""
    g, w16, w32 = _np(got), _np(jax16), _np(jax32)
    assert _rel(g, w16) <= tol, _rel(g, w16)
    assert _rel(g, w32) <= ACCURACY_SHARE * _rel(w16, w32), (_rel(g, w32), _rel(w16, w32))


def _port_sample(ld, setup, dtype, decoded, **kw):
    d = setup["data"]
    return ld.sample(torch.from_numpy(d["y"]), x_T=torch.from_numpy(d["x_T"]), temperature=0.0,
                     compute_dtype=dtype, return_decoded=decoded, **kw)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_f32_carry_on_bf16_parameters_is_the_f32_network_on_rounded_weights(setup, chain):
    kw = CHAINS[chain]
    port16 = build_pipeline(setup["tcfg"], device="cpu", params=setup["state16"])
    port32 = build_pipeline(setup["tcfg"], device="cpu", params=cast_to_fp32(setup["state16"]))
    assert next(port16.unet.parameters()).dtype == BF16
    latent = _port_sample(port16, setup, "float32", False, **kw)
    decoded = port16.decode_first_stage(latent)
    assert latent.dtype == decoded.dtype == torch.float32
    assert _bits_equal(latent, _port_sample(port32, setup, "float32", False, **kw))
    assert _bits_equal(decoded, port32.decode_first_stage(latent))
    # the promoted copies: one f32 copy of the UNet (the steps) and of the VAE (the decode)
    assert [next(m.parameters()).dtype for m in port16._unet.copies()] == [torch.float32]
    assert [next(m.parameters()).dtype for m in port16._vae.copies()] == [torch.float32]
    want = _jax_latent(setup, "j16", "float32", chain)
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(latent.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_bf16_carry_unet_forward_matches_jax(setup):
    from prediff_tpu.factory import build_unet as jbuild

    d, tcfg = setup["data"], setup["tcfg"]
    apply = jax.jit(jbuild(jax_load_config(jax_default_config, TINY)).apply)
    x, t, c = d["x_T"], d["t"], d["cond"]
    jax16 = apply({"params": setup["j16"]["unet"]}, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                  jnp.asarray(c, jnp.bfloat16))
    jax32 = apply({"params": setup["j16"]["unet"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c))
    unet = build_unet(tcfg).to(BF16).eval().requires_grad_(False)
    unet.load_state_dict(setup["state16"]["unet"])
    got = unet(torch.from_numpy(x).to(BF16), torch.from_numpy(t).long(),
               torch.from_numpy(c).to(BF16))
    assert got.dtype == BF16 and jax16.dtype == jnp.bfloat16
    _bf16_rule(got, jax16, jax32, FORWARD_TOL)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_bf16_carry_on_bf16_parameters_matches_jax(setup, chain):
    kw = CHAINS[chain]
    port = build_pipeline(setup["tcfg"], device="cpu", params=setup["state16"])
    latent = _port_sample(port, setup, "bfloat16", False, **kw)
    assert latent.dtype == BF16 and port._unet.copies() == []   # the bf16 network itself
    jax16 = _jax_latent(setup, "j16", "bfloat16", chain)
    _bf16_rule(latent, jax16, _jax_latent(setup, "j16", "float32", chain), LATENT_TOL)
    # the decode of a bf16 latent on the bf16 VAE is bf16, as JAX's
    decoded = port.decode_first_stage(latent)
    want = _jax_decode(setup, jax16)
    assert decoded.dtype == BF16 and want.dtype == jnp.bfloat16
    assert _rel(_np(decoded), _np(want)) <= DECODED_TOL


def test_precision_imports_no_jax():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'prediff_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import torch\n"
            "from prediff_torch.utils.precision import cast_to_bf16, cast_to_fp32\n"
            "sd = cast_to_bf16({'w': torch.ones(2), 'i': torch.arange(2)})\n"
            "assert sd['w'].dtype == torch.bfloat16 and sd['i'].dtype == torch.int64\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
