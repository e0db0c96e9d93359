"""The port's programs on the CPU, part 2 (``configs/tiny_smoke.yaml``,
in-process through ``main([...])``, one synthetic SEVIR-LR dataset):
``train_sevirlr_prediff`` logs the JAX script's keys (recorded below from a
JAX run) with ``valid_loss_epoch = -valid_csi_avg_epoch`` and resumes from
``--ckpt-name``; ``--test`` prints the test metrics and writes the dumps and
the example panel that ``tests/test_cli_smoke.py`` asserts of the JAX
script; the VAE-GAN and alignment programs train; ``precompute_latents``
writes a cache that both ``--latents`` trainers read."""
import json
import os

import h5py
import numpy as np
import pytest

from prediff_torch.cli import (precompute_latents, train_sevirlr_avg_x, train_sevirlr_prediff,
                               train_vae_sevirlr)
from prediff_torch.datasets import make_synthetic_sevir_lr
from prediff_torch.utils.checkpoint import all_steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "tiny_smoke.yaml")

# The keys of metrics.jsonl after
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
#   python scripts/train_sevirlr_prediff.py --save /tmp/pd --cfg configs/tiny_smoke.yaml \
#       --synthetic --max-steps 3
JAX_KEYS = {
    'logvar', 'step', 'time', 'val/loss', 'val/loss_gamma', 'val/loss_simple', 'val/loss_vlb',
    'valid_aligned_bias_133_epoch', 'valid_aligned_bias_160_epoch',
    'valid_aligned_bias_16_epoch', 'valid_aligned_bias_181_epoch',
    'valid_aligned_bias_219_epoch', 'valid_aligned_bias_74_epoch',
    'valid_aligned_bias_avg_epoch', 'valid_aligned_crps_epoch', 'valid_aligned_csi_133_epoch',
    'valid_aligned_csi_160_epoch', 'valid_aligned_csi_16_epoch', 'valid_aligned_csi_181_epoch',
    'valid_aligned_csi_219_epoch', 'valid_aligned_csi_74_epoch', 'valid_aligned_csi_avg_epoch',
    'valid_aligned_loss_epoch', 'valid_aligned_mae_epoch', 'valid_aligned_mse_epoch',
    'valid_aligned_pod_133_epoch', 'valid_aligned_pod_160_epoch', 'valid_aligned_pod_16_epoch',
    'valid_aligned_pod_181_epoch', 'valid_aligned_pod_219_epoch', 'valid_aligned_pod_74_epoch',
    'valid_aligned_pod_avg_epoch', 'valid_aligned_ssim_epoch', 'valid_aligned_sucr_133_epoch',
    'valid_aligned_sucr_160_epoch', 'valid_aligned_sucr_16_epoch',
    'valid_aligned_sucr_181_epoch', 'valid_aligned_sucr_219_epoch',
    'valid_aligned_sucr_74_epoch', 'valid_aligned_sucr_avg_epoch', 'valid_bias_133_epoch',
    'valid_bias_160_epoch', 'valid_bias_16_epoch', 'valid_bias_181_epoch',
    'valid_bias_219_epoch', 'valid_bias_74_epoch', 'valid_bias_avg_epoch', 'valid_crps_epoch',
    'valid_csi_133_epoch', 'valid_csi_160_epoch', 'valid_csi_16_epoch', 'valid_csi_181_epoch',
    'valid_csi_219_epoch', 'valid_csi_74_epoch', 'valid_csi_avg_epoch', 'valid_loss_epoch',
    'valid_mae_epoch', 'valid_mse_epoch', 'valid_pod_133_epoch', 'valid_pod_160_epoch',
    'valid_pod_16_epoch', 'valid_pod_181_epoch', 'valid_pod_219_epoch', 'valid_pod_74_epoch',
    'valid_pod_avg_epoch', 'valid_ssim_epoch', 'valid_sucr_133_epoch', 'valid_sucr_160_epoch',
    'valid_sucr_16_epoch', 'valid_sucr_181_epoch', 'valid_sucr_219_epoch',
    'valid_sucr_74_epoch', 'valid_sucr_avg_epoch'}


@pytest.fixture(scope="module")
def sevir(tmp_path_factory):
    """The synthetic SEVIR-LR dataset ``--synthetic`` writes (16 events, 32x32)."""
    root = str(tmp_path_factory.mktemp("data") / "synthetic_sevirlr")
    make_synthetic_sevir_lr(root, num_events=16, H=32, W=32, T=25)
    return root


def _records(save):
    with open(os.path.join(save, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _train(save, sevir, *extra):
    return train_sevirlr_prediff.main(["--save", save, "--cfg", TINY, "--sevir-dir", sevir,
                                       "--device", "cpu", *extra])


def test_train_logs_the_jax_keys_and_resumes(tmp_path, sevir, capsys):
    save = str(tmp_path / "prediff")
    assert _train(save, sevir, "--max-steps", "3") == 0
    records = _records(save)
    assert {k for r in records for k in r} == JAX_KEYS
    rec = next(r for r in records if "valid_loss_epoch" in r)
    assert rec["valid_loss_epoch"] == -rec["valid_csi_avg_epoch"] and rec["step"] == 3
    assert all(np.isfinite(v) for v in rec.values())
    vis = os.listdir(os.path.join(save, "vis"))
    assert "val_epoch1_data0.png" in vis and "train_epoch1.png" in vis
    assert all_steps(os.path.join(save, "ckpt_last")) == [3]
    # resume: the restored state continues at step 3
    assert _train(save, sevir, "--max-steps", "4", "--ckpt-name", "ckpt_last") == 0
    assert "training done at step 4" in capsys.readouterr().out
    assert all_steps(os.path.join(save, "ckpt_last")) == [3, 4]
    assert _records(save)[-1]["step"] == 4


def test_test_mode_scores_dumps_and_draws_the_example(tmp_path, sevir, capsys):
    save = str(tmp_path / "eval")
    assert _train(save, sevir, "--test", "--num-samples", "2", "--ddim-steps", "2") == 0
    out = capsys.readouterr().out
    for key in ("test_csi_avg_epoch", "test_fvd_epoch", "test_aligned_csi_avg_epoch",
                "test_aligned_fvd_epoch", "test_crps_epoch", "test_ssim_epoch"):
        assert f"{key}: " in out, key
    assert os.path.exists(os.path.join(save, "test_example_0.png"))
    assert {"batch0_rank0_sample0.npy", "batch0_rank0_sample1_aligned.npy"} <= set(
        os.listdir(os.path.join(save, "npy")))
    assert np.load(os.path.join(save, "npy", "batch0_rank0_sample1.npy")).shape == (2, 2, 32, 32, 1)


def test_vae_and_alignment_programs_train(tmp_path, sevir, capsys):
    save = str(tmp_path / "vae")
    assert train_vae_sevirlr.main(["--save", save, "--cfg", TINY, "--sevir-dir", sevir,
                                   "--max-steps", "2", "--device", "cpu"]) == 0
    assert "VAE training done at step 2; nll=" in capsys.readouterr().out
    assert all_steps(os.path.join(save, "ckpt_vae")) == [2]
    save = str(tmp_path / "align")
    assert train_sevirlr_avg_x.main(["--save", save, "--cfg", TINY, "--sevir-dir", sevir,
                                     "--max-steps", "2", "--device", "cpu"]) == 0
    assert "alignment training done at step 2; relative_mae=" in capsys.readouterr().out
    assert all_steps(os.path.join(save, "ckpt_align")) == [2]


def test_latent_cache_feeds_both_trainers(tmp_path, sevir):
    cache = str(tmp_path / "latents.h5")
    assert precompute_latents.main(["--out", cache, "--cfg", TINY, "--sevir-dir", sevir,
                                    "--aug", "d4", "--dtype", "float32", "--frame-batch", "25",
                                    "--device", "cpu"]) == 0
    with h5py.File(cache) as f:
        assert f["moments"].shape == (16, 8, 25, 4, 4, 16)
        assert json.loads(f.attrs["meta"])["encode_dtype"] == "float32"
    save = str(tmp_path / "prediff_lat")
    assert _train(save, sevir, "--latents", cache, "--max-steps", "3") == 0
    keys = {k for r in _records(save) for k in r}
    assert {"valid_csi_avg_epoch", "valid_loss_epoch"} <= keys   # validation stays on pixels
    assert train_sevirlr_avg_x.main(["--save", str(tmp_path / "align_lat"), "--cfg", TINY,
                                     "--sevir-dir", sevir, "--latents", cache,
                                     "--max-steps", "2", "--device", "cpu"]) == 0
