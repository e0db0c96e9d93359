"""Pre-encode a SEVIR(-LR) dataset into a VAE latent cache.

The frozen first stage is part of every pixel-input training step of the
diffusion model and of the alignment net; caching its moments once takes it
out of both (``--latents`` of their programs).  ``--aug d4`` caches all 8
flip / rot90 variants, which keeps augmentation mode "2" exact.  The cache
records the encoder's resolved ``first_stage_dtype`` as ``encode_dtype``.
Counterpart of ``scripts/precompute_latents.py``.

    python -m prediff_torch.cli.precompute_latents --out latents.h5 --sevir-dir /data/sevirlr \\
        --cfg configs/prediff_sevirlr_v1.yaml --pretrained-dir /path/to/pt --aug d4
    python -m prediff_torch.cli.precompute_latents --out /tmp/l.h5 --synthetic --device cpu
"""
import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from ..config import load_config, prediff_default_config
from ..datasets import SEVIRDataLoader
from ..datasets.latents import write_latent_cache
from ..factory import build_pipeline, build_vae
from ..utils.checkpoint import PRETRAINED_NAMES, load_torch_state_dict
from ..utils.device import resolve_device
from ..utils.precision import dtype_name
from ._common import add_device, sevir_dir_of

RAW_SEQ_LEN = {"sevir": 49, "sevirlr": 25}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, type=str, help="output .h5 path")
    p.add_argument("--cfg", default=None, type=str)
    p.add_argument("--sevir-dir", default=None, type=str)
    p.add_argument("--synthetic", action="store_true",
                   help="generate + encode a synthetic SEVIR-LR dataset")
    p.add_argument("--pretrained-dir", default=None, type=str,
                   help="directory with the published VAE .pt (else seeded weights: "
                        "smoke / testing only)")
    p.add_argument("--aug", default="d4", choices=["none", "d4"],
                   help="d4: cache all 8 flip/rot90 variants (needed for aug_mode '2' "
                        "training); none: 1 variant")
    p.add_argument("--dtype", default="float16", choices=["float16", "float32"],
                   help="storage dtype of the cached moments")
    p.add_argument("--frame-batch", default=32, type=int,
                   help="frames per encoder call (one shape for every call)")
    add_device(p)
    return p.parse_args(argv)


def encode_dataset(args: argparse.Namespace, cfg, sevir_dir: str, device) -> None:
    """The cache of every event under ``sevir_dir`` (the whole catalog, one
    shard, so that any date split maps onto it by event key)."""
    params = {}
    if args.pretrained_dir:
        params["vae"] = load_torch_state_dict(
            os.path.join(args.pretrained_dir, PRETRAINED_NAMES["vae"]), build_vae(cfg))
    else:
        print("WARNING: no --pretrained-dir; encoding with seeded VAE weights "
              "(smoke / testing only)", flush=True)
    ld = build_pipeline(cfg, with_alignment=False, device=device, params=params,
                        seed=cfg.optim.seed)

    def encode(frames: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return ld.first_stage_moments(torch.from_numpy(frames).to(device))

    raw_seq_len = RAW_SEQ_LEN[cfg.dataset.dataset_name]
    loader = SEVIRDataLoader(
        data_types=["vil"], seq_len=cfg.dataset.seq_len, raw_seq_len=raw_seq_len,
        sample_mode="sequent", stride=cfg.dataset.stride, batch_size=1, layout="NTHWC",
        sevir_catalog=os.path.join(sevir_dir, "CATALOG.csv"),
        sevir_data_dir=os.path.join(sevir_dir, "data"), shuffle=False,
        output_type=np.float32, preprocess=True, rescale_method="01")
    print(f"encoding {loader.total_num_event} events x {8 if args.aug == 'd4' else 1} "
          f"variant(s) x {raw_seq_len} frames -> {args.out}", flush=True)
    write_latent_cache(args.out, loader, encode, aug=args.aug, moments_dtype=args.dtype,
                       frame_batch=args.frame_batch, verbose=True,
                       encode_dtype=dtype_name(ld.first_stage_dtype))
    loader.close()
    print(f"latent cache written: {args.out}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(prediff_default_config, args.cfg)
    sevir_dir = sevir_dir_of(args, os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                                "synthetic_sevirlr"), cfg, 16)
    if sevir_dir is None:
        raise ValueError("pass --sevir-dir /path/to/sevirlr or --synthetic")
    encode_dataset(args, cfg, sevir_dir, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
