"""Training: optimizer and schedule, EMA, train state, the three trainers
(latent diffusion, VAE-GAN, knowledge alignment), loop."""
from .alignment_trainer import AlignmentTrainer
from .diffusion_trainer import DiffusionTrainer
from .ema import ema_decay, ema_update
from .loop import CheckpointTracker, EarlyStopper, MetricLogger, fit
from .optim import build_lr_schedule, build_optimizer, get_loss_fn
from .train_state import EmaTrainState
from .vae_trainer import VAETrainer

__all__ = ["AlignmentTrainer", "DiffusionTrainer", "VAETrainer", "EmaTrainState",
           "build_optimizer", "build_lr_schedule", "get_loss_fn", "ema_decay", "ema_update",
           "fit", "MetricLogger", "CheckpointTracker", "EarlyStopper"]
