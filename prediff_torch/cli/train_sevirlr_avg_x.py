"""Train the knowledge-alignment network U(z_t, t, y) on SEVIR-LR avg-x: it
regresses the per-frame mean intensity of the target from q-sampled noisy
latents, through the frozen VAE (published weights from
``--pretrained-dir``) or from a latent cache (``--latents``); the trainer of
``factory.build_alignment_trainer``, ``ckpt_align`` at the end.  With
``--multihost`` it trains on a mesh of every rank (``AlignmentTrainer(mesh=)``):
each rank loads ``micro_batch_size`` windows of its shard of the events a
micro-step, the same number on every rank, and rank 0 alone writes the
checkpoint and the metrics.  Counterpart of ``scripts/train_sevirlr_avg_x.py``.

    python -m prediff_torch.cli.train_sevirlr_avg_x --save align0 --pretrained-dir /path/to/pt
    python -m prediff_torch.cli.train_sevirlr_avg_x --save smoke --synthetic --max-steps 5 --device cpu
    torchrun --nproc_per_node=2 -m prediff_torch.cli.train_sevirlr_avg_x --save smoke --multihost \
        --synthetic --max-steps 2 --device cpu
"""
import argparse
import itertools
import os
import sys
from typing import Dict, List, Optional

from ..config import alignment_default_config, load_config, save_yaml
from ..datasets import SEVIRDataModule, prefetch_to_device
from ..factory import build_alignment_trainer, build_vae
from ..training import MetricLogger
from ..utils.checkpoint import PRETRAINED_NAMES, load_torch_state_dict, save_checkpoint, writes
from ..parallel.mesh import process_count, process_index
from ..utils.layout import layout_to_in_out_slice
from ._common import (add_device, equal_count, experiment_dir, join_processes, sevir_dir_of,
                      training_mesh)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save", default="tmp_align", type=str)
    p.add_argument("--cfg", default=None, type=str)
    p.add_argument("--sevir-dir", default=None, type=str)
    p.add_argument("--pretrained-dir", default=None, type=str)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--latents", default=None, type=str,
                   help="train from a pre-encoded VAE latent cache (precompute_latents)")
    p.add_argument("--max-steps", default=None, type=int)
    p.add_argument("--multihost", action="store_true",
                   help="train on a mesh of the processes torchrun (or --coordinator) names")
    p.add_argument("--coordinator", default=None, type=str,
                   help="coordinator address for --multihost (host:port)")
    add_device(p)
    return p.parse_args(argv)


def data_module(cfg, args: argparse.Namespace, save_dir: str) -> SEVIRDataModule:
    d = cfg.dataset
    dm = SEVIRDataModule(
        seq_len=d.seq_len, stride=d.stride, layout="NTHWC", aug_mode=d.aug_mode,
        dataset_name=d.dataset_name,
        sevir_dir=sevir_dir_of(args, os.path.join(save_dir, "synthetic_sevirlr"), cfg, 16),
        train_test_split_date=d.train_test_split_date, val_ratio=d.val_ratio,
        batch_size=cfg.optim.micro_batch_size, seed=cfg.optim.seed,
        num_shard=process_count(), rank=process_index())
    dm.setup()
    return dm


def train(args: argparse.Namespace, cfg, dm, device, save_dir: str) -> Dict[str, float]:
    """``--max-steps`` micro-steps (else ``max_epochs``) of the alignment net
    on ``dm``'s windows (or the cache's moments and frame means) on
    ``device``; logs every 50 steps, ``ckpt_align`` under ``save_dir``;
    returns the last step's metrics."""
    o = cfg.optim
    params = {}
    if args.pretrained_dir:
        params["vae"] = load_torch_state_dict(
            os.path.join(args.pretrained_dir, PRETRAINED_NAMES["vae"]), build_vae(cfg))
    mesh = training_mesh(device)
    trainer = build_alignment_trainer(cfg, device=device, params=params, seed=o.seed,
                                      total_num_steps=args.max_steps or 30_000,
                                      latent_inputs=args.latents is not None, mesh=mesh)
    n_train = equal_count(dm.num_train_samples // max(1, o.micro_batch_size), mesh)
    state = trainer.create_state()
    in_slice, out_slice = layout_to_in_out_slice(cfg.layout.layout, cfg.layout.in_len,
                                                 cfg.layout.out_len)
    logger = (MetricLogger(save_dir, use_wandb=cfg.logging.use_wandb,
                           run_name=cfg.logging.logging_prefix, config=cfg.to_dict())
              if writes(mesh) else None)
    latent_cache = None
    if args.latents:
        from ..datasets.latents import LatentCache

        latent_cache = LatentCache(args.latents)
    t0, t1 = cfg.layout.in_len, cfg.layout.in_len + cfg.layout.out_len

    def batches(epoch):
        if latent_cache is not None:
            # the target: the cached per-frame pixel means of the target window,
            # (B, T_out, 1), bounded as out_slice is
            items = ((m[out_slice], m[in_slice], fm[:, t0:t1, None])
                     for m, fm in dm.train_latent_batches(latent_cache, epoch)
                     if m.shape[0] == o.micro_batch_size)
        else:
            items = ((b[out_slice], b[in_slice]) for b in dm.train_batches(epoch)
                     if b.shape[0] == o.micro_batch_size)
        yield from prefetch_to_device(itertools.islice(items, n_train), size=2, device=device)

    step, metrics = 0, {}
    for epoch in range(o.max_epochs):
        for args_b in batches(epoch):
            state, metrics = trainer.train_step(state, o.seed, *args_b)
            step += 1
            if logger is not None and step % 50 == 0:
                logger.log(step, metrics)
            if args.max_steps and step >= args.max_steps:
                break
        if args.max_steps and step >= args.max_steps:
            break
    save_checkpoint(os.path.join(save_dir, "ckpt_align"), state, mesh=mesh)
    metrics = {k: float(v) for k, v in metrics.items()}
    print(f"alignment training done at step {step}; "
          f"relative_mae={metrics['relative_mae']:.4f}", flush=True)
    return metrics


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = join_processes(args)
    cfg = load_config(alignment_default_config, args.cfg)
    save_dir = experiment_dir(args.save)
    os.makedirs(save_dir, exist_ok=True)
    if process_index() == 0:
        save_yaml(cfg, os.path.join(save_dir, "cfg.yaml"))
    train(args, cfg, data_module(cfg, args, save_dir), device, save_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
