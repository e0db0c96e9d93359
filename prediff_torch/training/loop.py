"""Generic training loop: epochs over batches, periodic validation,
checkpoints (top-k by the monitored score + the latest), jsonl metric
logging, early stopping.  Counterpart of ``prediff_tpu/training/loop.py``.
On several ranks (``mesh``) every rank runs the loop on its own batches
(the same count on each: the steps' collectives pair up), and the mesh's
first rank alone writes the checkpoints and ``metrics.jsonl``; the others
wait for each checkpoint at a barrier.  The logged numbers are the trainers'
reduced ones, the same on every rank.
"""
import json
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..parallel.mesh import DataMesh
from ..utils.checkpoint import delete_checkpoint, save_checkpoint, writes


class MetricLogger:
    """Append-only jsonl logger, one record per call (``step``, ``time`` and
    the metrics that are numbers, as floats) in ``<save_dir>/metrics.jsonl``;
    also TensorBoard (``use_tensorboard``) and WandB (``use_wandb``), the
    same keys, each only where its package imports and starts: a host
    without them logs the jsonl alone, as the JAX package's logger does."""

    def __init__(self, save_dir: str, use_tensorboard: bool = False, use_wandb: bool = False,
                 run_name: Optional[str] = None, config: Optional[Dict[str, Any]] = None):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, "metrics.jsonl")
        self._tb = self._wandb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(save_dir)
            except Exception:   # absent or failing to start: the jsonl stays
                self._tb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=run_name or os.path.basename(save_dir) or "prediff", dir=save_dir,
                    config=config, resume="allow")
            except Exception:
                self._wandb = None

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"}, step=rec["step"])
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class CheckpointTracker:
    """Keeps the ``save_top_k`` checkpoints with the best monitored score and
    the latest one.  Retention is by score, not by recency, so a later, worse
    checkpoint never evicts the best.  ``best`` holds (score, step) pairs,
    best first."""

    def __init__(self, save_dir: str, monitor: str = "val/loss", mode: str = "min",
                 save_top_k: int = 3, mesh: Optional[DataMesh] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode '{mode}'")
        self.mesh = mesh
        self.save_dir = save_dir
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.best: list = []
        self.saved: set = set()   # steps on disk
        self.last_step: int = -1

    def is_improvement(self, score: float) -> bool:
        if len(self.best) < self.save_top_k:
            return True
        worst = self.best[-1][0]
        return score < worst if self.mode == "min" else score > worst

    def update(self, score: float, step: int, state: Any) -> None:
        path = os.path.join(self.save_dir, "ckpt")
        save_checkpoint(path, state, step=step, keep=None, mesh=self.mesh)
        self.last_step = step
        self.best.append((float(score), step))
        self.best.sort(key=lambda e: -e[0] if self.mode == "max" else e[0])
        self.best = self.best[: self.save_top_k]
        desired = {st for _, st in self.best} | {self.last_step}
        for st in sorted((self.saved | {step}) - desired):
            delete_checkpoint(path, st, mesh=self.mesh)
        self.saved = desired


class EarlyStopper:
    def __init__(self, patience: int = 100, mode: str = "min", enabled: bool = False):
        self.patience = patience
        self.mode = mode
        self.enabled = enabled
        self.best = np.inf if mode == "min" else -np.inf
        self.count = 0

    def should_stop(self, score: float) -> bool:
        if not self.enabled:
            return False
        improved = score < self.best if self.mode == "min" else score > self.best
        if improved:
            self.best = score
            self.count = 0
        else:
            self.count += 1
        return self.count > self.patience


def fit(state: Any, train_step: Callable, train_batches_fn: Callable[[int], Iterable],
        make_batch_args: Callable[[Any], tuple], max_epochs: int, save_dir: str,
        seed: Union[int, torch.Generator],
        val_fn: Optional[Callable[[Any], Dict[str, float]]] = None,
        check_val_every_n_epoch: int = 1, monitor: str = "val/loss", monitor_mode: str = "min",
        save_top_k: int = 3, early_stop: bool = False, early_stop_patience: int = 100,
        log_every_n_steps: int = 50, max_steps: Optional[int] = None,
        logger: Optional[MetricLogger] = None, train_step_scan: Optional[Callable] = None,
        steps_per_call: int = 1, mesh: Optional[DataMesh] = None):
    """Run the loop; returns the final state.

    ``train_batches_fn(epoch)`` yields batches; ``make_batch_args(batch)``
    maps one to the arguments of ``train_step`` after ``(state, seed)``.  A
    step here is one call of ``train_step`` (a micro-step when gradients are
    accumulated), as ``state.step`` counts them.  ``mesh``: the ranks
    training together (module docstring); its first rank alone logs and
    writes checkpoints.

    ``steps_per_call=K`` > 1 (with ``train_step_scan``, such as
    ``DiffusionTrainer.train_step_scan``; without one ``ValueError``) runs K
    steps a call: ``train_batches_fn`` then yields batches stacked (K, B, ...)
    on the leading axis, stacked on the host so that they cross to the card
    in one copy.  The same steps as K calls of ``train_step``; the metrics
    come back stacked (K,), are read once a call where one of its steps is
    on the logging cadence, and are logged per step on that cadence;
    ``max_steps`` rounds up to the call's boundary."""
    K = max(int(steps_per_call), 1)
    if K > 1 and train_step_scan is None:
        raise ValueError("steps_per_call > 1 requires train_step_scan")
    if writes(mesh):
        logger = logger if logger is not None else MetricLogger(save_dir)
    else:   # the other ranks log nothing
        logger = None
    tracker = CheckpointTracker(save_dir, monitor, monitor_mode, save_top_k, mesh)
    stopper = EarlyStopper(early_stop_patience, monitor_mode, early_stop)
    global_step = int(state.step)
    last_val_step = None

    def run_validation() -> bool:
        """Validate and checkpoint; True when early stopping says stop."""
        nonlocal last_val_step
        val_metrics = val_fn(state)
        if logger is not None:
            logger.log(global_step, val_metrics)
        last_val_step = global_step
        score = val_metrics.get(monitor)
        if score is not None:
            score = float(score)
            if tracker.is_improvement(score):
                tracker.update(score, global_step, state)
            if stopper.should_stop(score):
                return True
        return False

    stop = False
    for epoch in range(max_epochs):
        for batch in train_batches_fn(epoch):
            if K > 1:
                state, metrics = train_step_scan(state, seed, *make_batch_args(batch))
                base = global_step
                global_step += K
                if logger is not None and (global_step // log_every_n_steps
                                           > base // log_every_n_steps):
                    host = {m: v.detach().cpu() for m, v in metrics.items()}   # one read a call
                    for k in range(K):
                        if (base + k + 1) % log_every_n_steps == 0:
                            logger.log(base + k + 1, {m: v[k] for m, v in host.items()})
            else:
                state, metrics = train_step(state, seed, *make_batch_args(batch))
                global_step += 1
                if logger is not None and global_step % log_every_n_steps == 0:
                    logger.log(global_step, metrics)
            if max_steps is not None and global_step >= max_steps:
                stop = True  # mid-epoch: the final validation still runs below
                break
        if val_fn is not None and (stop or (epoch + 1) % check_val_every_n_epoch == 0):
            if run_validation():
                stop = True
        if stop:
            break
    # a run that ended between two validations still gets a last one, and its checkpoint
    if val_fn is not None and last_val_step != global_step and global_step > 0:
        run_validation()
    return state
