"""Train the frame-wise KL-VAE on SEVIR-LR with the GAN loss.

Two optimizers (generator: L1 + logvar NLL + KL + the adaptive adversarial
term; discriminator: hinge) over frames drawn as ``seq_len=1`` windows, the
trainer of ``factory.build_vae_trainer``; ``ckpt_vae`` at the end.
With ``--multihost`` it trains on a mesh of every rank (``VAETrainer(mesh=)``):
each rank loads ``micro_batch_size`` frames of its shard of the events a
step, the same number of steps on every rank, and rank 0 alone writes the
checkpoint and the metrics.  Counterpart of ``scripts/train_vae_sevirlr.py``.

    python -m prediff_torch.cli.train_vae_sevirlr --save vae0 --cfg configs/vae_sevirlr_v1.yaml
    python -m prediff_torch.cli.train_vae_sevirlr --save smoke --synthetic --max-steps 5 --device cpu
    torchrun --nproc_per_node=2 -m prediff_torch.cli.train_vae_sevirlr --save smoke --multihost \
        --synthetic --max-steps 2 --device cpu
"""
import argparse
import itertools
import os
import sys
from typing import Dict, List, Optional

import torch

from ..config import load_config, save_yaml, vae_training_default_config
from ..datasets import SEVIRDataModule, prefetch_to_device
from ..factory import build_vae_trainer
from ..training import MetricLogger
from ..utils.checkpoint import save_checkpoint, writes
from ..parallel.mesh import process_count, process_index
from ._common import (add_device, equal_count, experiment_dir, join_processes, sevir_dir_of,
                      training_mesh)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save", default="tmp_vae", type=str)
    p.add_argument("--cfg", default=None, type=str)
    p.add_argument("--sevir-dir", default=None, type=str)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--max-steps", default=None, type=int)
    p.add_argument("--multihost", action="store_true",
                   help="train on a mesh of the processes torchrun (or --coordinator) names")
    p.add_argument("--coordinator", default=None, type=str,
                   help="coordinator address for --multihost (host:port)")
    add_device(p)
    return p.parse_args(argv)


def data_module(cfg, args: argparse.Namespace, save_dir: str) -> SEVIRDataModule:
    """Frames: ``seq_len=1`` windows with stride 1."""
    d = cfg.dataset
    dm = SEVIRDataModule(
        seq_len=1, stride=1, layout="NTHWC", aug_mode=d.aug_mode, dataset_name=d.dataset_name,
        sevir_dir=sevir_dir_of(args, os.path.join(save_dir, "synthetic_sevirlr"), cfg, 16),
        train_test_split_date=d.train_test_split_date, val_ratio=d.val_ratio,
        batch_size=cfg.optim.micro_batch_size, seed=cfg.optim.seed,
        num_shard=process_count(), rank=process_index())
    dm.setup()
    return dm


def train(args: argparse.Namespace, cfg, dm, device, save_dir: str) -> Dict[str, float]:
    """``--max-steps`` steps (else ``max_epochs``) of the VAE-GAN on ``dm``'s
    frames on ``device``; logs every 50 steps, ``ckpt_vae`` under
    ``save_dir``; returns the last step's logs."""
    o = cfg.optim
    mesh = training_mesh(device)
    trainer = build_vae_trainer(cfg, device=device, seed=o.seed,
                                total_num_steps=args.max_steps or 100_000, mesh=mesh)
    n_train = equal_count(dm.num_train_samples // max(1, o.micro_batch_size), mesh)
    H = cfg.layout.img_height   # the JAX script initialises on one zero frame
    gen_state, disc_state, batch_stats = trainer.create_states(
        torch.zeros((1, H, H, cfg.model.vae.in_channels)))
    logger = (MetricLogger(save_dir, use_wandb=cfg.logging.use_wandb,
                           run_name=cfg.logging.logging_prefix, config=cfg.to_dict())
              if writes(mesh) else None)

    def frame_batches(epoch):
        frames = itertools.islice((b[:, 0] for b in dm.train_batches(epoch)   # (B, H, W, C)
                                   if b.shape[0] == o.micro_batch_size), n_train)
        yield from prefetch_to_device(frames, size=2, device=device)

    step, logs = 0, {}
    for epoch in range(o.max_epochs):
        for frames in frame_batches(epoch):
            gen_state, disc_state, batch_stats, logs = trainer.train_step(
                gen_state, disc_state, batch_stats, o.seed, frames)
            step += 1
            if logger is not None and step % 50 == 0:
                logger.log(step, logs)
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break
    save_checkpoint(os.path.join(save_dir, "ckpt_vae"), gen_state, mesh=mesh)
    logs = {k: float(v) for k, v in logs.items()}
    print(f"VAE training done at step {step}; nll={logs['train/nll_loss']:.4f}", flush=True)
    return logs


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = join_processes(args)
    cfg = load_config(vae_training_default_config, args.cfg)
    save_dir = experiment_dir(args.save)
    os.makedirs(save_dir, exist_ok=True)
    if process_index() == 0:
        save_yaml(cfg, os.path.join(save_dir, "cfg.yaml"))
    train(args, cfg, data_module(cfg, args, save_dir), device, save_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
