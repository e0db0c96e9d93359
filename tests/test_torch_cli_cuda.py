"""The programs on the card (``configs/tiny_smoke.yaml``): ``sample_prediff``'s
forecasts bit-equal to ``LatentDiffusion.sample`` with the generators the
program derives, and ``convert_pretrained``'s files forecasting bit for bit
as the ``.pt`` files they came from.  Every test needs a CUDA device and
skips without one.  This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cli_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from prediff_torch.cli import convert_pretrained, sample_prediff
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.datasets import synthetic_batch_iterator
from prediff_torch.diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
from prediff_torch.factory import build_alignment_model, build_pipeline, build_unet, build_vae
from prediff_torch.models.init import init_params_
from prediff_torch.serving import PreDiffPredictor
from prediff_torch.training.diffusion_trainer import step_generator
from prediff_torch.utils.checkpoint import PRETRAINED_NAMES

pytestmark = pytest.mark.cuda

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                    "tiny_smoke.yaml")


@pytest.fixture
def dev():
    """The card; decided per test, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _weights(cfg, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return {key: init_params_(build(cfg), gen, randomize=True).state_dict()
            for key, build in (("unet", build_unet), ("vae", build_vae),
                               ("align", build_alignment_model))}


def test_sample_program_forecasts_the_library_call(dev, tmp_path):
    cfg = load_config(prediff_default_config, TINY)
    args = sample_prediff.parse_args(["--out", str(tmp_path), "--num-contexts", "2",
                                      "--num-samples", "2", "--use-alignment",
                                      "--ddim-steps", "4"])
    ld = build_pipeline(cfg, with_alignment=True, device=dev, params=_weights(cfg))
    windows = list(synthetic_batch_iterator(1, 5, 32, 32, seed=1, num_batches=2))
    preds = sample_prediff.sample_contexts(args, cfg, ld, windows)
    for c, batch in enumerate(windows):
        b = torch.from_numpy(batch).to(dev)
        y, x = b[:, :3], b[:, 3:5]
        for i in range(2):
            want = ld.sample(y, use_alignment=True, alignment_kwargs=get_alignment_kwargs_avg_x(x),
                             sampler="ddim", ddim_steps=4, guidance_every_k=1,
                             generator=step_generator(0, c * 997 + i, dev))
            assert preds[c][i].shape == (1, 2, 32, 32, 1) and np.isfinite(preds[c][i]).all()
            assert np.array_equal(preds[c][i], want.cpu().numpy())
        assert not np.array_equal(preds[c][0], preds[c][1])


def test_converted_files_forecast_as_the_pt_files(dev, tmp_path):
    cfg = load_config(prediff_default_config, TINY)
    weights = _weights(cfg, seed=4)
    pt = tmp_path / "pt"
    pt.mkdir()
    for key, name in (("unet", "earthformerunet"), ("vae", "vae"), ("align", "alignment")):
        torch.save(weights[key], str(pt / PRETRAINED_NAMES[name]))
    convert_pretrained.convert(str(pt), str(tmp_path / "npz"), cfg=cfg)
    context = torch.rand((1, 3, 32, 32, 1), generator=torch.Generator().manual_seed(5))
    got = []
    for predictor in (PreDiffPredictor.from_npz(str(tmp_path / "npz"), cfg, device=dev),
                      PreDiffPredictor.from_torch(str(pt), cfg, device=dev)):
        got.append(predictor.predict(context, use_alignment=True, avg_x_gt=[[0.5]],
                                     ddim_steps=4,
                                     generator=torch.Generator(dev).manual_seed(0)).cpu())
    assert torch.isfinite(got[0]).all() and torch.equal(got[0], got[1])
