"""Pieces the programs share: the device flag, the experiment directory,
several processes (``--multihost`` / ``--coordinator``: the evaluation joins
its cluster, training refuses it), the synthetic dataset, eval mode for
sampling and host batches as tensors."""
import argparse
import contextlib
import os
from typing import Iterator, Optional

import torch
from torch import nn

from ..parallel.mesh import barrier, init_distributed, make_mesh, process_count, process_index
from ..training.diffusion_trainer import DDP_SLICE
from ..utils.device import resolve_device


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")


def experiment_dir(save: str) -> str:
    """``experiments/<save>``, or ``save`` itself when it is absolute."""
    return os.path.join("experiments", save)


def refuse_multihost(args: argparse.Namespace) -> None:
    """Training on several processes (DDP) is not ported: raise for
    ``--multihost``, ``--coordinator`` or ``--nodes`` above 1."""
    if (getattr(args, "multihost", False) or getattr(args, "coordinator", None)
            or getattr(args, "nodes", 1) > 1):
        raise NotImplementedError(f"--multihost / --coordinator / --nodes > 1: training on "
                                  f"more than one process is not ported ({DDP_SLICE})")


def join_processes(args: argparse.Namespace) -> torch.device:
    """The JAX scripts' ``--multihost`` / ``--coordinator host:port``: join
    the cluster that ``torchrun``'s environment or the coordinator names
    (``parallel.init_distributed``; one process when none is named).  The
    device: ``--device``, else the rank's card; cuDNN's deterministic
    algorithms are set on every rank before anything runs."""
    if args.multihost or args.coordinator:
        init_distributed(coordinator_address=args.coordinator, device=args.device)
    if args.device is None and process_count() > 1:
        return resolve_device(make_mesh().device)
    return resolve_device(args.device)


def sevir_dir_of(args: argparse.Namespace, synthetic_root: str, cfg, num_events: int
                 ) -> Optional[str]:
    """``--sevir-dir``, or with ``--synthetic`` a synthetic SEVIR-LR dataset at
    ``synthetic_root`` (written on the first call) at the configuration's
    frame size."""
    if not args.synthetic:
        return args.sevir_dir
    if not os.path.exists(synthetic_root) and process_index() == 0:   # one writer
        from ..datasets import make_synthetic_sevir_lr

        make_synthetic_sevir_lr(synthetic_root, num_events=num_events, H=cfg.layout.img_height,
                                W=cfg.layout.img_width, T=25)
    if process_count() > 1:
        barrier(make_mesh())
    return synthetic_root


@contextlib.contextmanager
def eval_mode(module: nn.Module) -> Iterator[None]:
    """``module`` in eval mode for the block (sampling from a model in
    training: no dropout), its mode restored after."""
    was = module.training
    module.eval()
    try:
        yield
    finally:
        module.train(was)


def as_tensor(batch, device) -> torch.Tensor:
    """A host batch (numpy or tensor) as an f32 tensor on ``device``."""
    return torch.as_tensor(batch, dtype=torch.float32).to(device)
