"""``PreDiffPredictor.from_npz`` and ``from_torch`` on configs/tiny_smoke.yaml
(CPU), held to the JAX package's constructors of the same names.

``from_npz`` reads the files that ``prediff_tpu.utils.checkpoint.save_params_npz``
writes from seeded flax parameters; ``from_torch`` reads ``.pt`` files
written from the port's state_dicts, plain and Lightning-wrapped, which the
JAX ``from_torch`` loads too.  The forecasts (same x_T, temperature 0,
guided) agree with the JAX package's; no published weights are used."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_unet import randomize_flax

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.serving import PreDiffPredictor as JaxPredictor
from prediff_tpu.utils.checkpoint import save_params_npz
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.utils.checkpoint import PRETRAINED_NAMES, load_flax_npz
from prediff_torch.utils.convert import flatten_tree

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# f32 on both sides, as tests/test_torch_chain.py
ATOL = RTOL = 1e-4
NPZ = {"unet": "earthformerunet.npz", "vae": "vae.npz", "align": "alignment.npz"}
PT = {"unet": "earthformerunet", "vae": "vae", "align": "alignment"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small tensors: the suite's
    workers share the CPU, and a thread per core in each of them makes such
    tests tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The npz files of seeded flax parameters, the JAX predictor that
    ``from_npz`` builds on them, its forecast, and the port's from them."""
    d = tmp_path_factory.mktemp("npz")
    jcfg = jax_load_config(jax_default_config, TINY)
    base = JaxPredictor(jcfg, with_alignment=True, mesh=None)
    for (key, fname), seed in zip(NPZ.items(), (5, 6, 7)):
        save_params_npz(str(d / fname), randomize_flax(base.params[key], seed))
    jpred = JaxPredictor.from_npz(str(d), cfg=jcfg, with_alignment=True, mesh=None)
    rs = np.random.RandomState(3)
    y, x_T = rs.rand(2, 3, 32, 32, 1).astype(np.float32), rs.randn(2, 2, 4, 4, 8).astype(np.float32)
    avg = np.array([[0.3], [0.7]], np.float32)
    sample = dict(timesteps=2, temperature=0.0, use_alignment=True)

    def jax_forecast(params):
        return np.asarray(jpred.ld.sample(params["unet"], params["vae"], jax.random.PRNGKey(0),
                                          jnp.asarray(y), align_params=params["align"],
                                          x_T=jnp.asarray(x_T),
                                          alignment_kwargs={"avg_x_gt": jnp.asarray(avg)},
                                          **sample))

    def forecast(predictor):
        return predictor.ld.sample(torch.from_numpy(y), x_T=torch.from_numpy(x_T),
                                   alignment_kwargs={"avg_x_gt": torch.from_numpy(avg)},
                                   **sample)

    tcfg = load_config(prediff_default_config, TINY)
    port = PreDiffPredictor.from_npz(str(d), cfg=tcfg, device="cpu")
    return dict(dir=d, jcfg=jcfg, tcfg=tcfg, jpred=jpred, want=jax_forecast(jpred.params),
                jax_forecast=jax_forecast, forecast=forecast, port=port)


def test_from_npz_reads_the_jax_export(weights):
    tree = load_flax_npz(str(weights["dir"] / NPZ["unet"]))
    flat, jflat = flatten_tree(tree), flatten_tree(weights["jpred"].params["unet"])
    assert sorted(flat) == sorted(jflat)
    for path, leaf in jflat.items():
        np.testing.assert_array_equal(flat[path], np.asarray(leaf), err_msg="/".join(path))
    got = weights["forecast"](weights["port"])
    assert got.shape == (2, 2, 32, 32, 1)
    np.testing.assert_allclose(got.numpy(), weights["want"], rtol=RTOL, atol=ATOL)


def test_from_torch_reads_reference_files(weights, tmp_path):
    """Plain and Lightning-wrapped files give the same forecast; the JAX
    package's ``from_torch`` reads the Lightning-wrapped ones."""
    port = weights["port"]
    models = {"unet": port.ld.unet, "vae": port.ld.vae, "align": port.ld.alignment.model}
    for wrapped in (False, True):
        (tmp_path / str(wrapped)).mkdir()
        for key, model in models.items():
            sd = model.state_dict()
            torch.save({"state_dict": sd} if wrapped else sd,
                       str(tmp_path / str(wrapped) / PRETRAINED_NAMES[PT[key]]))
    got = {wrapped: weights["forecast"](PreDiffPredictor.from_torch(
        str(tmp_path / str(wrapped)), cfg=weights["tcfg"], device="cpu"))
        for wrapped in (False, True)}
    torch.testing.assert_close(got[False], weights["forecast"](port), rtol=0, atol=0)
    torch.testing.assert_close(got[True], got[False], rtol=0, atol=0)
    jpred = JaxPredictor.from_torch(str(tmp_path / "True"), cfg=weights["jcfg"],
                                    with_alignment=True, mesh=None)
    want = weights["jax_forecast"](jpred.params)
    np.testing.assert_allclose(got[True].numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(want, weights["want"], rtol=RTOL, atol=ATOL)


def test_from_torch_refuses_a_missing_or_extra_key(weights, tmp_path):
    port = weights["port"]
    sds = {"unet": port.ld.unet.state_dict(), "vae": port.ld.vae.state_dict(),
           "align": port.ld.alignment.model.state_dict()}
    for key, sd in sds.items():
        torch.save(sd, str(tmp_path / PRETRAINED_NAMES[PT[key]]))
    loaded = PreDiffPredictor.from_torch(str(tmp_path), cfg=weights["tcfg"], device="cpu")
    assert loaded.ld.alignment is not None
    vae = dict(sds["vae"])
    dropped = vae.pop(sorted(vae)[0])
    torch.save(vae, str(tmp_path / PRETRAINED_NAMES["vae"]))
    with pytest.raises(RuntimeError, match="Missing key"):
        PreDiffPredictor.from_torch(str(tmp_path), cfg=weights["tcfg"], device="cpu")
    vae.update({sorted(sds["vae"])[0]: dropped, "decoder.extra.weight": torch.zeros(1)})
    torch.save(vae, str(tmp_path / PRETRAINED_NAMES["vae"]))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        PreDiffPredictor.from_torch(str(tmp_path), cfg=weights["tcfg"], device="cpu")
    # a derived buffer of the reference (recomputed by the port) is not a left-over key
    vae.pop("decoder.extra.weight")
    unet = dict(sds["unet"], **{"down_self_blocks.0.0.attn_l.0.relative_position_index":
                                torch.zeros(4, dtype=torch.long)})
    torch.save(vae, str(tmp_path / PRETRAINED_NAMES["vae"]))
    torch.save(unet, str(tmp_path / PRETRAINED_NAMES["earthformerunet"]))
    PreDiffPredictor.from_torch(str(tmp_path), cfg=weights["tcfg"], device="cpu")
