"""Pieces the programs share: the device flag, the experiment directory,
several processes (``--multihost`` / ``--coordinator``: every program joins
its cluster; the trainers then train on a mesh of every rank, each rank its
shard of the events, the same number of batches on each), the synthetic
dataset, eval mode for sampling and host batches as tensors."""
import argparse
import contextlib
import os
from typing import Iterator, Optional

import torch
from torch import nn

from ..parallel.mesh import (DataMesh, barrier, gather_parts, init_distributed, make_mesh,
                             process_count, process_index)
from ..utils.device import resolve_device


def add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None, type=str,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")


def experiment_dir(save: str) -> str:
    """``experiments/<save>``, or ``save`` itself when it is absolute."""
    return os.path.join("experiments", save)


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


def training_mesh(device) -> Optional[DataMesh]:
    """The trainers' mesh: every rank, on ``device``; None for one process."""
    return make_mesh(device=device) if process_count() > 1 else None


def equal_count(n: int, mesh: Optional[DataMesh]) -> int:
    """The fewest of the ranks' ``n``: the batches each rank takes, so that
    the steps' collectives pair up (a rank's shard of the events may hold a
    batch more)."""
    if mesh is None:
        return n
    return min(int(v) for v in gather_parts(torch.tensor([int(n)], device=mesh.device), mesh))


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
