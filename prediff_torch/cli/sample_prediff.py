"""Generate SEVIR-LR forecasts with PreDiff (the inference program).

Builds the pipeline (seeded weights, or the reference's published ``.pt``
files from ``--pretrained-dir``), samples ``--num-samples`` members per
context, writes ``ctx{c}_sample{i}.npy`` and, with ``--vis``, ``ctx{c}.png``.
Counterpart of ``scripts/sample_prediff.py``; member ``i`` of context ``c``
draws from ``step_generator(seed, c * 997 + i)``.

    python -m prediff_torch.cli.sample_prediff --out forecasts/ --synthetic \\
        --num-samples 2 --ddim-steps 50 [--device cpu]
"""
import argparse
import os
import sys
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..config import load_config, prediff_default_config
from ..datasets import SEVIRDataModule
from ..diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
from ..diffusion.latent_diffusion import LatentDiffusion
from ..factory import build_alignment_model, build_pipeline, build_unet, build_vae
from ..training.diffusion_trainer import step_generator
from ..utils.checkpoint import PRETRAINED_NAMES, load_torch_state_dict
from ..utils.device import resolve_device
from ..utils.layout import layout_to_in_out_slice
from ._common import add_device, as_tensor, sevir_dir_of


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="forecasts", type=str)
    p.add_argument("--cfg", default=None, type=str)
    p.add_argument("--pretrained-dir", default=None, type=str)
    p.add_argument("--sevir-dir", default=None, type=str)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--num-contexts", default=1, type=int)
    p.add_argument("--num-samples", default=1, type=int)
    p.add_argument("--use-alignment", action="store_true")
    p.add_argument("--guidance-every-k", default=1, type=int,
                   help="apply the alignment mean shift only every k-th step, scaled by k "
                        "(opt-in speed/semantics trade)")
    p.add_argument("--ddim-steps", default=None, type=int,
                   help="use the DDIM fast sampler with this many steps")
    p.add_argument("--timesteps", default=None, type=int)
    p.add_argument("--vis", action="store_true", help="also save PNG panels")
    p.add_argument("--seed", default=0, type=int)
    add_device(p)
    return p.parse_args(argv)


def build_sampler(cfg, args: argparse.Namespace, device) -> LatentDiffusion:
    """The frozen pipeline on ``device``: the published weights from
    ``--pretrained-dir`` (VAE, UNet, and the alignment net with
    ``--use-alignment``), else the seeded initialisation."""
    params = {}
    if args.pretrained_dir:
        models = {"vae": build_vae, "unet": build_unet}
        if args.use_alignment:
            models["align"] = build_alignment_model
        files = {"vae": "vae", "unet": "earthformerunet", "align": "alignment"}
        params = {key: load_torch_state_dict(
            os.path.join(args.pretrained_dir, PRETRAINED_NAMES[files[key]]), build(cfg))
            for key, build in models.items()}
    return build_pipeline(cfg, with_alignment=args.use_alignment, device=device, params=params,
                          seed=args.seed)


def sample_kwargs(args: argparse.Namespace, x: torch.Tensor) -> dict:
    """The sampler's keyword arguments for target ``x``."""
    kwargs = {}
    if args.ddim_steps:
        kwargs.update(sampler="ddim", ddim_steps=args.ddim_steps)
    if args.timesteps:
        kwargs["timesteps"] = args.timesteps
    if args.use_alignment:
        kwargs.update(use_alignment=True, alignment_kwargs=get_alignment_kwargs_avg_x(x),
                      guidance_every_k=args.guidance_every_k)
    return kwargs


def sample_contexts(args: argparse.Namespace, cfg, ld: LatentDiffusion,
                    batches: Iterable) -> List[List[np.ndarray]]:
    """Forecast the first ``--num-contexts`` windows of ``batches`` (host
    arrays (1, T, H, W, C)), ``--num-samples`` members each, into
    ``--out``; returns the members of each context."""
    in_slice, out_slice = layout_to_in_out_slice(cfg.layout.layout, cfg.layout.in_len,
                                                 cfg.layout.out_len)
    done = []
    for cidx, batch in enumerate(batches):
        if cidx >= args.num_contexts:
            break
        batch = as_tensor(batch, ld.device)
        y, x = batch[in_slice], batch[out_slice]
        preds = []
        for i in range(args.num_samples):
            pred = ld.sample(y, generator=step_generator(args.seed, cidx * 997 + i, ld.device),
                             **sample_kwargs(args, x))
            preds.append(pred.cpu().numpy())
            np.save(os.path.join(args.out, f"ctx{cidx}_sample{i}.npy"), preds[-1])
        if args.vis:
            from ..datasets.visualization import vis_sevir_seq

            vis_sevir_seq(os.path.join(args.out, f"ctx{cidx}.png"),
                          seq=[y[0].cpu(), x[0].cpu()] + [p[0] for p in preds],
                          label=["context", "target"] + [f"pred_{i}" for i in range(len(preds))],
                          interval_real_time=cfg.dataset.interval_real_time,
                          plot_stride=cfg.dataset.plot_stride)
        print(f"context {cidx}: wrote {len(preds)} forecast(s)", flush=True)
        done.append(preds)
    return done


def data_module(cfg, args: argparse.Namespace) -> SEVIRDataModule:
    """Windows of one, from ``--sevir-dir`` or the synthetic dataset under ``--out``."""
    d = cfg.dataset
    dm = SEVIRDataModule(
        seq_len=d.seq_len, stride=d.stride, layout="NTHWC", dataset_name=d.dataset_name,
        sevir_dir=sevir_dir_of(args, os.path.join(args.out, "synthetic_sevirlr"), cfg, 8),
        train_test_split_date=d.train_test_split_date, val_ratio=d.val_ratio, batch_size=1,
        seed=args.seed)
    dm.setup()
    return dm


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(prediff_default_config, args.cfg)
    os.makedirs(args.out, exist_ok=True)
    dm = data_module(cfg, args)
    sample_contexts(args, cfg, build_sampler(cfg, args, device), dm.test_batches())
    return 0


if __name__ == "__main__":
    sys.exit(main())
