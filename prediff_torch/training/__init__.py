"""Diffusion training: optimizer and schedule, EMA, train state, trainer, loop."""
from .diffusion_trainer import DiffusionTrainer
from .ema import ema_decay, ema_update
from .loop import CheckpointTracker, EarlyStopper, MetricLogger, fit
from .optim import build_lr_schedule, build_optimizer, get_loss_fn
from .train_state import EmaTrainState

__all__ = ["DiffusionTrainer", "EmaTrainState", "build_optimizer", "build_lr_schedule",
           "get_loss_fn", "ema_decay", "ema_update", "fit", "MetricLogger", "CheckpointTracker",
           "EarlyStopper"]
