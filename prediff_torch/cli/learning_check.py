"""Does-it-learn check: 400 diffusion training steps of
``configs/tiny_smoke.yaml`` on synthetic windows, with ``linear_end = 0.3``
(real noise at 8 steps; with the config's low-noise schedule the
eps-prediction floor is near 0.93 by construction), must cut the loss: the
mean of the last 20 steps' ``loss_simple`` below 0.95 x the first 20's.
Counterpart of ``scripts/learning_check.py``, on the card unless
``--device cpu``.

    python -m prediff_torch.cli.learning_check [--device cpu]
"""
import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import load_config, prediff_default_config
from ..datasets import synthetic_batch_iterator
from ..factory import build_training_pipeline
from ..training import DiffusionTrainer
from ..utils.device import resolve_device

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "configs", "tiny_smoke.yaml")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def learning_check(device, steps: int = 400) -> Tuple[float, float]:
    """``steps`` training steps from seed 0 on 8 synthetic batches of 4, in
    turn; returns the means of the first and the last 20 steps' loss."""
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.diffusion.linear_end = 0.3   # abar_7 ~ 0.3
    ld = build_training_pipeline(cfg, device=device)
    print("abar:", ld.schedule.alphas_cumprod.cpu().numpy(), flush=True)
    trainer = DiffusionTrainer(ld, optim_config=dict(lr=2e-3, total_num_steps=steps,
                                                     warmup_percentage=0.02))
    state = trainer.create_state()
    batches = [torch.from_numpy(b).to(ld.device) for b in synthetic_batch_iterator(
        batch_size=4, seq_len=5, H=32, W=32, num_batches=8)]
    losses = []
    for step in range(steps):
        b = batches[step % len(batches)]
        state, m = trainer.train_step(state, 0, b[:, 3:5], b[:, :3])
        losses.append(float(m["train/loss_simple"]))
        if step % 50 == 0 or step == steps - 1:
            print(step, "loss_simple", round(losses[-1], 4), flush=True)
    return float(np.mean(losses[:20])), float(np.mean(losses[-20:]))


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    first, last = learning_check(resolve_device(args.device))
    print(f"first20={first:.3f} last20={last:.3f}", flush=True)
    if not last < first * 0.95:
        print("did not learn", flush=True)
        return 1
    print("LEARNS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
