"""Train / evaluate PreDiff (latent diffusion) on SEVIR-LR.

The configuration is YAML over ``prediff_default_config()``; the VAE and
the alignment net may come from the reference's published ``.pt`` files.
Training: AdamW + EMA with gradient accumulation (``fit``), batches through
``prefetch_to_device`` (or cached latent moments with ``--latents``), and a
validation per ``check_val_every_n_epoch``: the val loss, and sampled
forecasts of the example windows scored by the aligned and unaligned suites,
``valid_loss_epoch = -valid_csi_avg_epoch`` the checkpoint monitor.
``--test``: ensemble forecasts of the test windows scored by the suites
(skill scores, MSE / MAE / SSIM, CRPS, FVD), ``.npy`` dumps and an example
PNG; with ``--multihost`` on several ranks (``torchrun``) each rank scores its
shard of the test events, the suites are summed across the ranks
(``cross_process_reduce``) and rank 0 logs them.  Training with
``--multihost`` runs on a mesh of every rank (``DiffusionTrainer(mesh=)``):
each rank loads ``micro_batch_size`` windows of its shard of the events a
micro-step, as the JAX script loads them per process, so a micro-step's
global batch is ``micro_batch_size x ranks``; the gradients are all-reduced
every micro-step, the same number of batches runs on every rank, and rank 0
alone writes checkpoints, metrics and panels.  An optimizer step sums
``accum_steps`` micro-steps: the JAX script's
``total_batch_size // (micro_batch_size x devices x --nodes)``, the devices
being the mesh's ranks (:func:`accum_steps`).  Counterpart of
``scripts/train_sevirlr_prediff.py``; its draws come from
``step_generator(cfg.optim.seed, n)`` with the JAX script's numbers ``n``.

    python -m prediff_torch.cli.train_sevirlr_prediff --save exp0 --cfg configs/prediff_sevirlr_v1.yaml
    python -m prediff_torch.cli.train_sevirlr_prediff --save exp0 --test --pretrained-dir /path/to/pt
    python -m prediff_torch.cli.train_sevirlr_prediff --save smoke --synthetic --max-steps 10 --device cpu
    torchrun --nproc_per_node=8 -m prediff_torch.cli.train_sevirlr_prediff --save exp0 --test \
        --multihost --pretrained-dir /path/to/pt
    torchrun --nproc_per_node=8 -m prediff_torch.cli.train_sevirlr_prediff --save exp0 \
        --multihost --pretrained-dir /path/to/pt
    torchrun --nproc_per_node=2 -m prediff_torch.cli.train_sevirlr_prediff --save smoke \
        --multihost --synthetic --max-steps 2 --device cpu --cfg configs/tiny_smoke.yaml
"""
import argparse
import itertools
import os
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import load_config, prediff_default_config, save_yaml
from ..datasets import SEVIRDataModule, prefetch_to_device, stack_chunks
from ..diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
from ..diffusion.latent_diffusion import LatentDiffusion
from ..evaluation import (ForecastEvalSuite, FrechetVideoDistance, InceptionI3d, i3d_feature_fn,
                          seeded_i3d)
from ..factory import build_alignment_model, build_pipeline, build_unet, build_vae
from ..parallel.mesh import process_count, process_index
from ..training import DiffusionTrainer, MetricLogger, fit
from ..training.diffusion_trainer import step_generator
from ..training.train_state import EmaTrainState
from ..utils.checkpoint import (PRETRAINED_NAMES, load_torch_state_dict, restore_checkpoint,
                                save_checkpoint)
from ..utils.layout import layout_to_in_out_slice
from ..utils.checkpoint import writes
from ._common import (add_device, as_tensor, equal_count, eval_mode, experiment_dir,
                      join_processes, sevir_dir_of, training_mesh)

# the JAX script's draw numbers (the data it folds into its key)
VAL_SAMPLE = 7919        # validation n, batch b: 7919 * n + b
TRAIN_VIS = 2_000_003    # the train example of validation n: 2_000_003 + n


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--save", default="tmp_prediff", type=str)
    p.add_argument("--cfg", default=None, type=str)
    p.add_argument("--test", action="store_true")
    p.add_argument("--ckpt-name", default=None, type=str)
    p.add_argument("--pretrained-dir", default=None, type=str,
                   help="directory with the published .pt weights")
    p.add_argument("--sevir-dir", default=None, type=str)
    p.add_argument("--synthetic", action="store_true",
                   help="use a generated synthetic SEVIR-LR dataset")
    p.add_argument("--latents", default=None, type=str,
                   help="train from a pre-encoded VAE latent cache (precompute_latents): drops "
                        "the frozen encoder from the train step")
    p.add_argument("--max-steps", default=None, type=int)
    p.add_argument("--nodes", default=1, type=int)
    p.add_argument("--num-samples", default=None, type=int,
                   help="override eval.num_samples_per_context (ensemble size)")
    p.add_argument("--ddim-steps", default=None, type=int,
                   help="evaluate with the DDIM fast sampler")
    p.add_argument("--timesteps", default=None, type=int,
                   help="truncate the DDPM chain during eval")
    p.add_argument("--multihost", action="store_true",
                   help="join the processes torchrun (or --coordinator) names: training on a "
                        "mesh of every rank, or --test scored across them")
    p.add_argument("--coordinator", default=None, type=str,
                   help="coordinator address for --multihost (host:port)")
    add_device(p)
    return p.parse_args(argv)


def data_module(cfg, args: argparse.Namespace, save_dir: str) -> SEVIRDataModule:
    """The SEVIR-LR data module; on several ranks each reads its shard of the
    events (``num_shard`` / ``rank``), as the JAX script's."""
    d = cfg.dataset
    dm = SEVIRDataModule(
        seq_len=d.seq_len, stride=d.stride, layout=d.layout, aug_mode=d.aug_mode,
        dataset_name=d.dataset_name,
        sevir_dir=sevir_dir_of(args, os.path.join(save_dir, "synthetic_sevirlr"), cfg, 16),
        start_date=d.start_date, train_test_split_date=d.train_test_split_date,
        end_date=d.end_date, val_ratio=d.val_ratio, batch_size=cfg.optim.micro_batch_size,
        seed=cfg.optim.seed, num_shard=process_count(), rank=process_index())
    dm.setup()
    return dm


def uses_alignment(cfg) -> bool:
    return cfg.model.align.alignment_type is not None


def build_models(cfg, args: argparse.Namespace, device) -> LatentDiffusion:
    """The pipeline on ``device``: with the alignment net when the
    configuration has one, the UNet trainable unless ``--test``.  From
    ``--pretrained-dir``: the VAE, the alignment net and, with ``--test``,
    the UNet; the others take the seeded initialisation."""
    use_align = uses_alignment(cfg)
    params = {}
    if args.pretrained_dir:
        wanted = {"vae": (build_vae, "vae")}
        if args.test:
            wanted["unet"] = (build_unet, "earthformerunet")
        if use_align:
            wanted["align"] = (build_alignment_model, "alignment")
        params = {key: load_torch_state_dict(
            os.path.join(args.pretrained_dir, PRETRAINED_NAMES[name]), build(cfg))
            for key, (build, name) in wanted.items()}
    return build_pipeline(cfg, with_alignment=use_align, device=device, params=params,
                          seed=cfg.optim.seed, trainable_unet=not args.test)


def accum_steps(cfg, devices: int = 1, nodes: int = 1) -> int:
    """Micro-steps per optimizer step: the JAX script's ``total_batch_size //
    (micro_batch_size x devices x nodes)``, ``devices`` the training mesh's
    ranks (one card a rank), ``nodes`` its ``--nodes``.  On several hosts the
    ranks already count every host's cards, so ``--nodes`` above 1 counts
    them twice, as the JAX formula does (ROADMAP.md section 4)."""
    return max(1, cfg.optim.total_batch_size // (cfg.optim.micro_batch_size * devices * nodes))


def make_trainer(cfg, ld: LatentDiffusion, total_steps: int, accum: int,
                 latent_inputs: bool, mesh=None) -> DiffusionTrainer:
    """The recipe's trainer (on ``mesh`` when given); the TPU knobs of the
    configuration go to it, and one it does not take raises there."""
    o = cfg.optim
    return DiffusionTrainer(
        ld, optim_config=dict(
            lr=o.lr, total_num_steps=total_steps, method=o.method, wd=o.wd,
            betas=tuple(o.betas), gradient_clip_val=o.gradient_clip_val,
            warmup_percentage=o.warmup_percentage, lr_scheduler_mode=o.lr_scheduler_mode,
            min_lr_ratio=o.min_lr_ratio, warmup_min_lr_ratio=o.warmup_min_lr_ratio,
            accum_steps=accum, state_dtype=o.get("state_dtype", None)),
        use_ema=cfg.model.diffusion.use_ema,
        # Lightning semantics: track_grad_norm=-1 is off, p >= 1 logs norms
        track_grad_norm=cfg.logging.track_grad_norm != -1,
        latent_inputs=latent_inputs, mesh=mesh, prng_impl=o.get("prng_impl", "auto"),
        flat_update=o.get("flat_update", False), pack_small_thr=o.get("pack_small_thr", 0),
        matmul_precision=o.get("matmul_precision", None),
        conv3d_impl=o.get("conv3d_impl", "auto"), ema_dtype=o.get("ema_dtype", None))


def make_suite(cfg, fvd: Optional[FrechetVideoDistance] = None) -> ForecastEvalSuite:
    return ForecastEvalSuite(
        layout=cfg.layout.layout, metrics_mode=cfg.dataset.metrics_mode,
        seq_len=cfg.layout.out_len, threshold_list=tuple(cfg.dataset.threshold_list),
        metrics_list=tuple(cfg.dataset.metrics_list), fvd=fvd)


def train(args: argparse.Namespace, cfg, dm, device, save_dir: str,
          ld: Optional[LatentDiffusion] = None) -> EmaTrainState:
    """Train the UNet of ``ld`` (default: :func:`build_models`) on ``dm``'s
    batches (or the latent cache of ``--latents``) on ``device``, validating
    as the configuration says; ``ckpt_last`` under ``save_dir`` at the end.
    ``dm`` needs ``train_batches(epoch)``, ``val_batches()``,
    ``num_train_samples``, ``num_val_samples`` and, with ``--latents``,
    ``train_latent_batches``.  On several ranks (the process group
    ``--multihost`` joined) every rank trains on its shard, the same number
    of batches an epoch."""
    ld = ld if ld is not None else build_models(cfg, args, device)
    o = cfg.optim
    seed = o.seed
    mesh = training_mesh(device)
    micro = max(1, o.micro_batch_size)
    n_train = equal_count(dm.num_train_samples // micro, mesh)
    n_val = equal_count(dm.num_val_samples // micro, mesh)
    total_steps = args.max_steps or n_train * o.max_epochs
    trainer = make_trainer(cfg, ld, total_steps,
                           accum_steps(cfg, 1 if mesh is None else mesh.size, args.nodes),
                           latent_inputs=args.latents is not None, mesh=mesh)
    # steps_per_call K > 1: K micro-steps a call (DiffusionTrainer.train_step_scan) on
    # (K, B, ...) chunks of K host batches stacked before the copy to the card; with
    # --multihost each rank stacks its own shard's batches, its rows of the JAX chunk
    steps_per_call = max(1, int(o.get("steps_per_call", 1)))
    state = trainer.create_state()
    if args.ckpt_name:
        restore_checkpoint(os.path.join(save_dir, args.ckpt_name), state)
    in_slice, out_slice = layout_to_in_out_slice(cfg.layout.layout, cfg.layout.in_len,
                                                 cfg.layout.out_len)
    latent_cache = None
    if args.latents:
        from ..datasets.latents import LatentCache

        latent_cache = LatentCache(args.latents)
    train_example = {}   # the first train batch of the epoch, for the example forecast

    def chunked(source):
        return stack_chunks(source, steps_per_call) if steps_per_call > 1 else source

    def train_batches(epoch):
        """Host reads, augmentation and slicing in the prefetch's producer
        thread; the batches (with ``steps_per_call`` K > 1 the (K, B, ...)
        chunks of K, a ragged tail dropped) reach ``device`` through pinned
        memory."""
        if latent_cache is not None:
            # (mx, my) windows of cached moments; validation stays on pixels
            source = dm.train_latent_batches(latent_cache, epoch)
            yield from prefetch_to_device(chunked(itertools.islice(
                ((m[out_slice], m[in_slice]) for m, _ in source
                 if m.shape[0] == o.micro_batch_size), n_train)), size=2, device=device)
            return
        pixels = itertools.islice(((b[out_slice], b[in_slice]) for b in dm.train_batches(epoch)
                                   if b.shape[0] == o.micro_batch_size),   # no ragged tail
                                  n_train)
        for i, xy in enumerate(prefetch_to_device(chunked(pixels), size=2, device=device)):
            if i == 0:   # one (B, ...) batch: a chunk's first
                train_example["xy"] = tuple(a[0] for a in xy) if steps_per_call > 1 else xy
            yield xy

    suite_names = ((["aligned"] if uses_alignment(cfg) and cfg.eval.eval_aligned else [])
                   + (["unaligned"] if cfg.eval.eval_unaligned else []))
    val_ddim = cfg.eval.val_ddim_steps
    val_sampler = (dict(sampler="ddim", ddim_steps=int(val_ddim))
                   if val_ddim and val_ddim < cfg.model.diffusion.timesteps else {})
    if writes(mesh):
        os.makedirs(os.path.join(save_dir, "vis"), exist_ok=True)
    val_count = {"n": 0}

    def val_fn(state) -> Dict[str, float]:
        """The val loss (EMA weights; pixel batches even from latents) and the
        example windows' forecasts (the trained weights) scored by the
        suites, as the reference's validation epoch.  On several ranks each
        scores its shard (the same number of batches); the losses are reduced
        by the val step, the suites summed across the ranks, and rank 0 alone
        draws the panels."""
        val_count["n"] += 1
        n = val_count["n"]
        vals = []
        suites = {name: make_suite(cfg) for name in suite_names}
        vis_saved = not writes(mesh)
        for bidx, b in enumerate(dm.val_batches()):
            if len(vals) == n_val:
                break
            if b.shape[0] != o.micro_batch_size:
                continue
            b = as_tensor(b, device)
            x, y = b[out_slice], b[in_slice]
            m = trainer.val_step(state, seed, x, y, latent_inputs=False)
            vals.append({k: float(v) for k, v in m.items()})
            data_idx = bidx * o.micro_batch_size
            if cfg.eval.eval_example_only and data_idx not in cfg.eval.val_example_data_idx_list:
                continue
            vis_preds, vis_labels = [], []
            for name, suite in suites.items():
                kwargs = dict(val_sampler)
                if name == "aligned":
                    kwargs.update(use_alignment=True,
                                  alignment_kwargs=get_alignment_kwargs_avg_x(x))
                with eval_mode(ld.unet):
                    preds = ld.sample_ensemble(
                        y, cfg.eval.num_samples_per_context,
                        generator=step_generator(seed, VAL_SAMPLE * n + bidx, device), **kwargs)
                suite.update(preds, x)
                vis_preds.append(preds[0])
                vis_labels.append(f"{name}_pred")
            if not vis_saved:
                try:
                    save_example_vis(save_dir, cfg, y, x, vis_preds, vis_labels,
                                     f"vis/val_epoch{n}_data{data_idx}")
                except Exception as e:   # an example panel never stops training
                    print(f"val vis failed: {e}")
                vis_saved = True
        if "xy" in train_example and writes(mesh):
            x, y = train_example["xy"]
            with eval_mode(ld.unet):
                pred = ld.sample_ensemble(y, 1, generator=step_generator(seed, TRAIN_VIS + n, device),
                                          **val_sampler)
            try:
                save_example_vis(save_dir, cfg, y, x, [pred[0]], ["train_pred"],
                                 f"vis/train_epoch{n}")
            except Exception as e:
                print(f"train vis failed: {e}")
        out = {k: float(np.mean([v[k] for v in vals])) for k in vals[0]} if vals else {}
        for name, suite in suites.items():
            suite.cross_process_reduce()
            out.update(suite.compute("valid" if name == "unaligned" else "valid_aligned"))
        return out

    logger = (MetricLogger(save_dir, use_wandb=cfg.logging.use_wandb,
                           run_name=cfg.logging.logging_prefix, config=cfg.to_dict())
              if writes(mesh) else None)
    state = fit(state, trainer.train_step, train_batches, lambda b: b,
                max_epochs=o.max_epochs, save_dir=save_dir, seed=seed, val_fn=val_fn,
                check_val_every_n_epoch=cfg.trainer.check_val_every_n_epoch,
                monitor=o.monitor, save_top_k=o.save_top_k, early_stop=o.early_stop,
                early_stop_patience=o.early_stop_patience, max_steps=args.max_steps,
                logger=logger, steps_per_call=steps_per_call, mesh=mesh,
                train_step_scan=trainer.train_step_scan if steps_per_call > 1 else None)
    save_checkpoint(os.path.join(save_dir, "ckpt_last"), state, mesh=mesh)
    print(f"training done at step {state.step}; checkpoints in {save_dir}", flush=True)
    return state


def build_fvd_feature_fn(cfg, pretrained_dir: Optional[str]) -> Tuple[Callable, int]:
    """One I3D feature extractor for the aligned and unaligned FVDs: the
    published Kinetics I3D from ``pretrained_dir`` where it is, else a
    seeded I3D whose FVD checks the wiring only (its value means nothing)."""
    nf = int(cfg.eval.fvd_features)
    name = PRETRAINED_NAMES.get(f"i3d{nf}")
    path = os.path.join(pretrained_dir, name) if pretrained_dir and name else None
    if path and os.path.exists(path):
        model = InceptionI3d(num_classes=nf)
        model.load_state_dict(load_torch_state_dict(path, model))
        model.eval()
    else:
        print("WARNING: Kinetics I3D weights not found; FVD uses a seeded random I3D "
              "(relative values meaningless; wiring-only mode)", flush=True)
        model = seeded_i3d(nf)
    return i3d_feature_fn(model, int(cfg.eval.fvd_resolution)), nf


def run_eval(args: argparse.Namespace, cfg, ld: LatentDiffusion, dm, save_dir: str
             ) -> Dict[str, float]:
    """The ``test_*`` metrics of :func:`score_test_set`'s suites, summed
    across the ranks (``cross_process_reduce``) and returned on each; rank 0
    alone logs and prints them."""
    suites = score_test_set(args, cfg, ld, dm, save_dir)
    results = {}
    for name, suite in suites.items():
        suite.cross_process_reduce()
        results.update(suite.compute("test" if name == "unaligned" else "test_aligned"))
    if process_index() == 0:
        MetricLogger(save_dir).log(0, results)
        for k in sorted(results):
            print(f"{k}: {results[k]:.4f}")
    return results


def score_test_set(args: argparse.Namespace, cfg, ld: LatentDiffusion, dm, save_dir: str
                   ) -> Dict[str, ForecastEvalSuite]:
    """Score ensemble forecasts of ``dm.test_batches()`` by the suites, by
    name (``aligned``: steered by 2x the target's mean; ``unaligned``): each
    batch, each suite draws ``step_generator(seed, batch)``;
    ``npy/batch{b}_rank{r}_sample{i}[_aligned].npy`` and
    ``test_example_{idx}.png`` under ``save_dir``.  On several ranks ``dm``
    is this rank's shard and ``batch`` its own count, as the JAX script folds
    its local batch index into the key; each rank samples its batches
    without a mesh and writes its own dumps, and rank 0 alone draws the
    examples."""
    device = ld.device
    rank = process_index()
    seed = cfg.optim.seed
    use_align = uses_alignment(cfg) and cfg.eval.eval_aligned
    sampler = {}
    if args.ddim_steps:
        sampler = dict(sampler="ddim", ddim_steps=args.ddim_steps)
    if args.timesteps:
        sampler["timesteps"] = args.timesteps
    names = (["aligned"] if use_align else []) + (["unaligned"] if cfg.eval.eval_unaligned
                                                  else [])
    feature_fn = nf = None
    if cfg.eval.fvd:
        feature_fn, nf = build_fvd_feature_fn(cfg, args.pretrained_dir)
    suites = {name: make_suite(cfg, FrechetVideoDistance(
        feature_fn=feature_fn, num_features=nf, auto_t=True, reset_real_features=False)
        if feature_fn is not None else None) for name in names}
    in_slice, out_slice = layout_to_in_out_slice(cfg.layout.layout, cfg.layout.in_len,
                                                 cfg.layout.out_len)
    npy_dir = os.path.join(save_dir, "npy")
    if cfg.logging.save_npy:
        os.makedirs(npy_dir, exist_ok=True)
    n_samples = args.num_samples or cfg.eval.num_samples_per_context
    for bidx, batch in enumerate(dm.test_batches()):
        data_idx = bidx * cfg.optim.micro_batch_size
        if cfg.eval.eval_example_only and data_idx not in cfg.eval.test_example_data_idx_list:
            continue
        batch = as_tensor(batch, device)
        x, y = batch[out_slice], batch[in_slice]
        vis_preds, vis_labels = [], []
        for name, suite in suites.items():
            kwargs = dict(sampler)
            if name == "aligned":
                kwargs.update(use_alignment=True, alignment_kwargs=get_alignment_kwargs_avg_x(x))
            preds = ld.sample_ensemble(y, n_samples, generator=step_generator(seed, bidx, device),
                                       **kwargs)   # (M, B, T, H, W, C)
            suite.update(preds, x)
            if cfg.logging.save_npy:
                suffix = "_aligned" if name == "aligned" else ""
                for i, p in enumerate(preds):
                    fname = f"batch{bidx}_rank{rank}_sample{i}{suffix}.npy"
                    np.save(os.path.join(npy_dir, fname), p.cpu().numpy())
            vis_preds.append(preds[0])
            vis_labels.append(f"{name}_pred")
        if vis_preds and rank == 0:
            try:
                save_example_vis(save_dir, cfg, y, x, vis_preds, vis_labels,
                                 f"test_example_{data_idx}")
            except Exception as e:   # an example panel never stops the evaluation
                print(f"vis failed: {e}")
    return suites


def save_example_vis(save_dir: str, cfg, y, x, preds, labels, tag: str) -> None:
    """The example forecast's PNG: context, target and each prediction of
    the batch's first window."""
    from ..datasets.visualization import vis_sevir_seq

    vis_sevir_seq(f"{save_dir}/{tag}.png", seq=[y[0], x[0]] + [p[0] for p in preds],
                  label=["context", "target"] + list(labels),
                  interval_real_time=cfg.dataset.interval_real_time,
                  plot_stride=cfg.dataset.plot_stride, fs=cfg.eval.fs)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = join_processes(args)
    cfg = load_config(prediff_default_config, args.cfg)
    save_dir = experiment_dir(args.save)
    os.makedirs(save_dir, exist_ok=True)
    if process_index() == 0:
        save_yaml(cfg, os.path.join(save_dir, "cfg.yaml"))
    dm = data_module(cfg, args, save_dir)
    ld = build_models(cfg, args, device)
    if args.test:
        run_eval(args, cfg, ld, dm, save_dir)
    else:
        train(args, cfg, dm, device, save_dir, ld)
    return 0


if __name__ == "__main__":
    sys.exit(main())
