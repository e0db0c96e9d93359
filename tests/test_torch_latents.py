"""The port's latent cache (``prediff_torch/datasets/latents.py``) on the CPU:
the D4 maps and draws against the pixel augmentation and the JAX package's
draws, caches written by both packages from the same files with the same
numpy encode function (equal files, and each package reads the other's),
latent batches equal to the JAX ones and to the encoded pixel batches, and
the port's diffusion and alignment trainers fed from moments against the
same trainers fed pixels at configs/tiny_smoke.yaml's widths, at the bars of
tests/test_latents.py (losses 1e-6 relative, the loss dicts 1e-5).
"""
import json
import os

import h5py
import numpy as np
import pytest
import torch

import prediff_tpu.datasets as jd
import prediff_tpu.datasets.latents as jl
import prediff_torch.datasets as td
import prediff_torch.datasets.latents as tl
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_alignment_model, build_training_pipeline
from prediff_torch.training import AlignmentTrainer, DiffusionTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_smoke.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_d4_maps_exhaustive():
    """apply_d4 with (fh, fw, k) -> m*4 + j gives every flipH^fh, flipW^fw,
    rot90^k combination, each group element twice."""
    x = np.arange(5 * 4 * 6 * 2, dtype=np.float32).reshape(5, 4, 6, 2)
    counts = np.zeros(8, np.int64)
    for fh in (0, 1):
        for fw in (0, 1):
            for k in range(4):
                ref = x
                if fh:
                    ref = np.flip(ref, axis=1)
                if fw:
                    ref = np.flip(ref, axis=2)
                ref = np.rot90(ref, k=k, axes=(1, 2))
                v = (fh ^ fw) * 4 + (k + 2 * fw) % 4
                counts[v] += 1
                np.testing.assert_array_equal(tl.apply_d4(x, v, 1, 2), ref)
                np.testing.assert_array_equal(tl.apply_d4(x, v, 1, 2), jl.apply_d4(x, v, 1, 2))
    assert (counts == 2).all()


def test_draws_match_pixel_aug_and_jax():
    x = np.random.RandomState(0).rand(3, 8, 8, 1).astype(np.float32)
    rng_pix, rng_lat, rng_jax = (np.random.default_rng(123) for _ in range(3))
    for _ in range(25):
        pix = td.augment_seq(x.copy(), "THWC", "2", rng_pix)
        v = tl.draw_d4_variant(rng_lat, "2")
        assert v == jl.draw_d4_variant(rng_jax, "2")
        np.testing.assert_array_equal(tl.apply_d4(x, v, 1, 2), pix)
    assert tl.draw_d4_variant(rng_lat, "0") == 0
    with pytest.raises(NotImplementedError):
        tl.draw_d4_variant(rng_lat, "1")


def _encode_numpy(frames: np.ndarray) -> np.ndarray:
    """A stand-in encoder: (n, 32, 32, 1) -> (n, 8, 8, 2) block means and
    their squares' log."""
    n = frames.shape[0]
    blocks = frames.reshape(n, 8, 4, 8, 4, 1).mean(axis=(2, 4))
    return np.concatenate([blocks, np.log(blocks**2 + 1e-3)], axis=-1).astype(np.float32)


def _loader(pkg, root, T=25):
    return pkg.SEVIRDataLoader(data_types=["vil"], seq_len=5, raw_seq_len=T, stride=5,
                               batch_size=1, layout="NTHWC",
                               sevir_catalog=os.path.join(root, "CATALOG.csv"),
                               sevir_data_dir=os.path.join(root, "data"))


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    base = tmp_path_factory.mktemp("latents")
    root = td.make_synthetic_sevir_lr(str(base / "sevirlr"), num_events=6, H=32, W=32, T=25,
                                      seed=2)
    paths = {}
    for name, pkg, lat in (("port", td, tl), ("jax", jd, jl)):
        loader = _loader(pkg, root)
        paths[name] = str(base / f"{name}.h5")
        lat.write_latent_cache(paths[name], loader, _encode_numpy, aug="d4",
                               moments_dtype="float32", frame_batch=16)
        loader.close()
    return dict(root=root, paths=paths, base=base)


def test_caches_equal(caches):
    p, j = caches["paths"]["port"], caches["paths"]["jax"]
    with h5py.File(p, "r") as a, h5py.File(j, "r") as b:
        assert set(a) == set(b) == {"moments", "frame_mean", "keys"}
        assert a["moments"].shape == (6, 8, 25, 8, 8, 2)
        for k in ("moments", "frame_mean", "keys"):
            np.testing.assert_array_equal(a[k][:], b[k][:])
        assert json.loads(a.attrs["meta"]) == json.loads(b.attrs["meta"])
    for reader in (tl.LatentCache, jl.LatentCache):
        cp, cj = reader(p), reader(j)
        for args in ((0, 3, 5, 5), (5, 7, 20, 5)):
            for a, b in zip(cp.read_window(*args), cj.read_window(*args)):
                np.testing.assert_array_equal(a, b)
        cp.close()
        cj.close()
    with pytest.raises(FileNotFoundError):
        tl.LatentCache(str(caches["base"] / "missing.h5"))


def test_latent_batches_equal_jax(caches):
    """The same window order and D4 draws (aug "2") from each package's data
    module over its own cache; the port's reads the JAX-written cache too."""
    kw = dict(seq_len=5, stride=5, layout="NTHWC", aug_mode="2", dataset_name="sevirlr",
              sevir_dir=caches["root"], val_ratio=0.2, batch_size=2, seed=3)
    dp, dj = td.SEVIRDataModule(**kw), jd.SEVIRDataModule(**kw)
    dp.setup()
    dj.setup()
    cp, cj = tl.LatentCache(caches["paths"]["port"]), jl.LatentCache(caches["paths"]["jax"])
    for epoch in (0, 1):
        got = list(dp.train_latent_batches(cp, epoch))
        want = list(dj.train_latent_batches(cj, epoch))
        cross = list(dp.train_latent_batches(tl.LatentCache(caches["paths"]["jax"]), epoch))
        assert len(got) == len(want) == len(cross) >= 2
        for (gm, gf), (wm, wf), (xm, xf) in zip(got, want, cross):
            assert gm.shape == (2, 5, 8, 8, 2) and gf.shape == (2, 5)
            np.testing.assert_array_equal(gm, wm)
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gm, xm)
    # the pixel epoch it stands for: same windows, same D4 elements
    pix = list(dp.train_batches(0))
    for b, (mom, fm) in zip(pix, dp.train_latent_batches(cp, 0)):
        want = np.stack([_encode_numpy(seq) for seq in b])
        np.testing.assert_allclose(mom, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(fm, b.mean(axis=(2, 3, 4)), rtol=1e-6, atol=1e-6)
    lds = tl.LatentSEVIRDataset(dp._trainval, cp, seed=0, aug_mode="0")
    assert len(lds) == dp._trainval.total_num_seq
    with pytest.raises(ValueError, match="d4"):
        c1 = str(caches["base"] / "one.h5")
        loader = _loader(td, caches["root"])
        tl.write_latent_cache(c1, loader, _encode_numpy, aug="none", moments_dtype="float32")
        loader.close()
        tl.LatentSEVIRDataset(dp._trainval, tl.LatentCache(c1), aug_mode="2")


@pytest.fixture(scope="module")
def tiny():
    cfg = load_config(prediff_default_config, TINY)
    ld = build_training_pipeline(cfg, device="cpu", seed=0)
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.rand(2, cfg.layout.out_len, 32, 32, 1).astype(np.float32))
    y = torch.from_numpy(rs.rand(2, cfg.layout.in_len, 32, 32, 1).astype(np.float32))
    return cfg, ld, x, y


def _moments(ld, x):
    """Pixel seq (B, T, H, W, C) -> its encoder moments (B, T, h, w, 2c)."""
    B = x.shape[0]
    with torch.no_grad():
        m = ld.first_stage_moments(x.reshape((-1,) + tuple(x.shape[2:])))
    return m.reshape((B, -1) + tuple(m.shape[1:]))


def test_write_cache_with_the_port_vae(tiny, caches):
    """write_latent_cache with the VAE's moments as a tensor-valued encode:
    the latent batches are the encoded pixel batches (frames padded to
    ``frame_batch``, so another batch composition: the JAX test's bars)."""
    cfg, ld, _, _ = tiny
    path = str(caches["base"] / "vae.h5")
    loader = _loader(td, caches["root"])
    tl.write_latent_cache(path, loader, lambda f: ld.first_stage_moments(torch.from_numpy(f)),
                          aug="d4", moments_dtype="float32", frame_batch=25)
    loader.close()
    dm = td.SEVIRDataModule(seq_len=5, stride=5, layout="NTHWC", aug_mode="2",
                            sevir_dir=caches["root"], val_ratio=0.2, batch_size=2, seed=3)
    dm.setup()
    pix = list(dm.train_batches(0))
    lat = list(dm.train_latent_batches(tl.LatentCache(path), 0))
    for b, (mom, _) in list(zip(pix, lat))[:2]:
        want = _moments(ld, torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(mom, want, atol=2e-4, rtol=1e-4)


def test_diffusion_trainer_latent_equals_pixel(tiny):
    """The training loss from moments equals the pixel loss for the same
    draws; the trainer's train step (one each, from the same weights) and
    its pixel-input val step agree."""
    cfg, ld, x, y = tiny
    mx, my = _moments(ld, x), _moments(ld, y)
    logvar = ld.init_logvar()
    loss_p, dict_p = ld.training_loss(logvar, torch.Generator().manual_seed(7), x, y, "t")
    loss_l, dict_l = ld.training_loss_from_moments(logvar, torch.Generator().manual_seed(7),
                                                   mx, my, "t")
    np.testing.assert_allclose(float(loss_l.detach()), float(loss_p.detach()), rtol=1e-6)
    for k in dict_p:
        np.testing.assert_allclose(float(dict_l[k].detach()), float(dict_p[k].detach()), rtol=1e-5,
                                   atol=1e-7)

    saved = {k: v.clone() for k, v in ld.unet.state_dict().items()}
    steps = {}
    try:
        for latent, args in ((False, (x, y)), (True, (mx, my))):
            ld.unet.load_state_dict(saved)
            tr = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=4),
                                  latent_inputs=latent)
            state = tr.create_state()
            val = tr.val_step(state, 5, x, y, latent_inputs=False)
            state, m = tr.train_step(state, 5, *args)
            steps[latent] = (m, val)
    finally:
        ld.unet.load_state_dict(saved)
    (m_p, v_p), (m_l, v_l) = steps[False], steps[True]
    np.testing.assert_allclose(float(m_l["train/loss"]), float(m_p["train/loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m_l["grad_norm"]), float(m_p["grad_norm"]), rtol=1e-5)
    assert float(v_l["val/loss"]) == float(v_p["val/loss"])


def test_alignment_trainer_latent_equals_pixel(tiny):
    """The alignment loss from cached moments and frame means equals the
    pixel loss for the same draws; the latent step without its target is
    refused."""
    cfg, ld, x, y = tiny
    net = build_alignment_model(cfg)
    d = cfg.model.diffusion

    def make(latent):
        return AlignmentTrainer(net, ld.vae, timesteps=d.timesteps, scale_factor=d.scale_factor,
                                latent_inputs=latent)

    net.eval()
    loss_p, d_p = make(False).loss_fn(torch.Generator().manual_seed(11), x, y)
    mx, my = _moments(ld, x), _moments(ld, y)
    target = x.mean(dim=(2, 3, 4))[..., None]
    loss_l, d_l = make(True).loss_fn(torch.Generator().manual_seed(11), mx, my, target)
    np.testing.assert_allclose(float(loss_l.detach()), float(loss_p.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(d_l["relative_mae"].detach()),
                               float(d_p["relative_mae"].detach()), rtol=1e-5)
    with pytest.raises(ValueError, match="target"):
        make(True).loss_fn(torch.Generator().manual_seed(11), mx, my)
