"""Ranks of ``torch.distributed`` as the JAX package's data mesh: one process
per card, launched by ``torchrun`` or started by :func:`init_distributed`.

Counterpart of ``prediff_tpu/parallel/mesh.py``.  There a 1-D ``data`` mesh
places the parameters replicated and the batch (ensemble members included)
sharded, and XLA inserts the collectives.  Here every rank holds the whole
model and its own rows of the batch, and the collectives are written out:
:func:`shard_batch` takes this rank's rows, :func:`replicate` broadcasts from
the mesh's first rank, :func:`gather_batch` all-gathers axis 0 (the
counterpart of reading a global ``jax.Array`` whole) and :func:`all_reduce_sum`
sums a tensor over the ranks.  Training adds :func:`all_reduce_mean` (the
gradients' mean over the ranks, every tensor of a list in one flat bucket:
one collective, one host round trip on gloo, not one a parameter, on
:func:`all_reduce_sum_`, which sums a flat buffer's parts in place),
:func:`reduce_loss_dict` (a loss dict's means over the ranks),
:func:`all_reduce_sum_grad` (a sum autograd differentiates: the backward is
the sum of the ranks' cotangents, for the discriminator's batch statistics),
:func:`replicate_` (tensors set in place to the first rank's, one bucket) and
:func:`batch_rows` (a rank's rows of the global batch, for the draws).

The backend is NCCL on the card and gloo on the CPU.  Gloo takes a CUDA
tensor only through the host, so the collectives here copy a CUDA tensor to
the host and back on a gloo group: two ranks that share one card (NCCL
refuses two ranks on one device) run that way, eagerly.  A gloo collective
cannot be captured in a CUDA graph; an NCCL one can, once its communicator
exists (``diffusion/latent_diffusion.py`` runs one before its first capture).

The JAX module's ``replicated_sharding``, ``batch_sharding`` and
``chunk_sharding`` are XLA placement objects; their uses take the functions
above.  ``chunk_sharding`` (a (K, B, ...) chunk of ``steps_per_call``
micro-batches split on its second axis) is each rank stacking its own
(K, B_local, ...) chunk: ``DiffusionTrainer.train_step_scan`` on a mesh
reduces every micro-step's gradients as the eager step does, inside the
captured micro-step on NCCL, between its two graphs through the host on
gloo (``training/step_graphs.py``).
"""
import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# the device init_distributed gave this process's rank
_RANK_DEVICE = {}


@dataclass(frozen=True)
class DataMesh:
    """A 1-D data mesh: the process group (None: the default group), its
    global ranks in mesh order, this process's global rank and its device.
    A rank outside ``ranks`` holds the mesh but takes no part in it
    (``member`` is False), as :func:`make_data_mesh` leaves the ranks past
    its prefix."""
    group: Any
    ranks: Tuple[int, ...]
    rank: int
    device: torch.device

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.rank in self.ranks

    @property
    def index(self) -> int:
        """This rank's position in the mesh (its shard)."""
        if not self.member:
            raise ValueError(f"rank {self.rank} is not in the mesh {self.ranks}")
        return self.ranks.index(self.rank)

    @property
    def distributed(self) -> bool:
        """Whether the mesh has a process group (a mesh made without one is
        this process alone, and its collectives are the identity)."""
        return dist.is_initialized()

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group)) if self.distributed else "none"

    def key(self) -> tuple:
        """What a captured step depends on: size, shard and backend."""
        return (self.size, self.index, self.backend)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def _rank_device(device) -> torch.device:
    """The rank's device: ``device`` if given, else ``cuda:LOCAL_RANK``
    (raising without a card, or when ``LOCAL_RANK`` is past the cards)."""
    if device is not None:
        return resolve_device(device)
    local = _env_int("LOCAL_RANK") or 0
    resolve_device(None)   # raises without a card
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} but only {torch.cuda.device_count()} CUDA "
                           "devices: one process per card")
    return torch.device("cuda", local)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: float = 300.0) -> bool:
    """Join this process to its cluster: the DDP process group (reference
    ``train_sevirlr_prediff.py:648`` DDPStrategy over NCCL).

    The cluster is named by ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) or by the arguments
    (``coordinator_address`` as ``host:port``, as JAX's, with
    ``num_processes`` and ``process_id``, each from the environment where not
    given).  The rank's device is ``device``, else ``cuda:LOCAL_RANK``, made
    the current card; the backend NCCL on a card and gloo on the CPU unless
    ``backend`` names one.  Returns True if the group is (already) up, False
    when no cluster is named: the run has one process, JAX's no-cluster case.
    A named cluster whose rendezvous fails within ``timeout`` seconds
    raises: a run launched on several ranks never quietly becomes separate
    runs."""
    if dist.is_initialized():
        return True
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and (world is None or "MASTER_ADDR" not in os.environ):
        if world is not None and world > 1:
            raise ValueError("WORLD_SIZE is set but MASTER_ADDR is not: name the coordinator")
        return False
    if world is None or rank is None:
        raise ValueError("a named cluster needs its world size and this process's rank "
                         "(num_processes / process_id, or WORLD_SIZE / RANK)")
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = (f"tcp://{coordinator_address}" if coordinator_address is not None
                   else "env://")
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    _RANK_DEVICE["device"] = dev
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _default_device() -> torch.device:
    """The device :func:`init_distributed` gave this rank; else, whatever
    made the group (or with none), the rank's card: ``cuda:LOCAL_RANK``, or
    the current card without ``LOCAL_RANK``.  It raises without a card: the
    CPU is taken only where the caller names it."""
    if "device" in _RANK_DEVICE:
        return _RANK_DEVICE["device"]
    if _env_int("LOCAL_RANK") is not None:
        return _rank_device(None)
    resolve_device(None)   # raises without a card
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(ranks: Optional[Sequence[int]] = None, device=None) -> DataMesh:
    """A data mesh over every rank (or the given ones, a group made
    collectively: every rank calls this with the same ``ranks``).  Without a
    process group: a mesh of this one process.  ``device``: the rank's
    (default: the one :func:`init_distributed` gave it, else its card)."""
    dev = torch.device(device) if device is not None else _default_device()
    if not dist.is_initialized():
        return DataMesh(group=None, ranks=(0,), rank=0, device=dev)
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(int(r) for r in ranks)
    group = None if ranks == tuple(range(world)) else dist.new_group(list(ranks))
    return DataMesh(group=group, ranks=ranks, rank=dist.get_rank(), device=dev)


def make_data_mesh(batch_size: int, ranks: Optional[Sequence[int]] = None,
                   device=None) -> DataMesh:
    """A data mesh over the largest prefix of the ranks whose count divides
    ``batch_size`` (a 2-sample micro-batch on 8 ranks uses 2).  Every rank
    calls it (the subgroup is made collectively); a rank past the prefix
    gets a mesh whose ``member`` is False."""
    ranks = list(range(process_count())) if ranks is None else list(ranks)
    k = len(ranks)
    while k > 1 and batch_size % k != 0:
        k -= 1
    return make_mesh(ranks[:k], device=device)


def make_2d_mesh(data: int, model: int, ranks: Optional[Sequence[int]] = None, device=None):
    """A (data, model) ``DeviceMesh`` for tensor-sharded variants; nothing
    uses it, as in the JAX package.  The ranks' count must be
    ``data * model``."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(process_count())) if ranks is None else list(ranks)
    if len(ranks) != data * model:
        raise ValueError(f"{len(ranks)} ranks for a ({data}, {model}) mesh")
    dev = torch.device(device) if device is not None else _default_device()
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def local_batch_slice(global_batch_size: int, num_shards: Optional[int] = None,
                      shard_id: Optional[int] = None) -> slice:
    """The rows of shard ``shard_id`` of ``num_shards`` (default: this
    process of all of them) in a global batch: the reference's
    num_shard / rank split."""
    num_shards = process_count() if num_shards is None else num_shards
    shard_id = process_index() if shard_id is None else shard_id
    if global_batch_size % num_shards != 0:
        raise ValueError(f"batch {global_batch_size} does not split into {num_shards} shards")
    per = global_batch_size // num_shards
    return slice(shard_id * per, (shard_id + 1) * per)


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(batch, mesh: DataMesh):
    """This rank's rows of every leaf's leading axis, on its device."""
    def rows(t):
        t = torch.as_tensor(t)
        return t[local_batch_slice(t.shape[0], mesh.size, mesh.index)].to(mesh.device)

    return _map(rows, batch)


def _via_host(t: torch.Tensor, mesh: DataMesh) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def replicate(tree, mesh: DataMesh):
    """Every leaf on the rank's device, equal to the mesh's first rank's
    (a broadcast from it)."""
    def bcast(t):
        t = torch.as_tensor(t).to(mesh.device).clone()
        if mesh.distributed:
            buf = t.cpu() if _via_host(t, mesh) else t
            dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
            t = buf.to(mesh.device)
        return t

    return _map(bcast, tree)


def all_reduce_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """A new tensor, the sum of ``t`` over the mesh's ranks: the same bits on
    every rank.  Not differentiable: callers write their chain rule out."""
    out = t.clone()
    all_reduce_sum_(out, mesh)
    return out


# every tensor of a bucket starts on a multiple of 4 elements (16 bytes): the
# multi-tensor kernels (``torch._foreach_norm``, the fused optimizer) then take
# their aligned path on its views, and sum as they do on separate tensors
BUCKET_ALIGN = 4


def bucket_sizes(like: Sequence) -> list:
    """The elements each of ``like`` (tensors or shapes) takes in a bucket:
    its own, padded to ``BUCKET_ALIGN``."""
    return [-(-int(t.numel()) // BUCKET_ALIGN) * BUCKET_ALIGN for t in like]


def bucket_views(flat: torch.Tensor, like: Sequence) -> list:
    """Views of the bucket ``flat`` shaped as ``like`` (tensors or shapes)."""
    shapes = [t if isinstance(t, torch.Size) else t.shape for t in like]
    return [part[:s.numel()].view(s) for part, s in zip(flat.split(bucket_sizes(like)), shapes)]


def _bucket(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket takes one dtype, got {sorted(map(str, dtypes))}")
    flat = torch.zeros(sum(bucket_sizes(tensors)), dtype=tensors[0].dtype,
                       device=tensors[0].device)
    torch._foreach_copy_(bucket_views(flat, tensors), [t.detach() for t in tensors])
    return flat


def all_reduce_sum_(flat: torch.Tensor, mesh: Optional[DataMesh], parts: Sequence[int] = (),
                    host: Optional[torch.Tensor] = None) -> None:
    """In place: each consecutive part of the 1-D ``flat`` (of sizes
    ``parts``; none: the whole tensor, of any shape) the sum of its
    counterparts over the mesh's ranks, one collective a part, so each part
    holds the bits that a reduction of it alone gives.  On gloo a CUDA
    ``flat`` goes through the host in one copy each way (into ``host``, a
    buffer of its size and dtype there, pinned so that the copy back does
    not block the host; else a new one).  Nothing without a mesh or its
    group."""
    if mesh is None or not mesh.distributed:
        return
    via = _via_host(flat, mesh)
    if via and host is not None:
        host.copy_(flat)
        buf = host
    else:
        buf = flat.cpu() if via else flat
    for part in (buf.split(list(parts)) if parts else (buf,)):
        dist.all_reduce(part, group=mesh.group)
    if via:
        flat.copy_(buf, non_blocking=host is not None)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> list:
    """New tensors, each the mean of its counterparts over the mesh's ranks
    (the sum, then divided by the size: the same bits on every rank), all of
    one dtype reduced as one flat bucket.  Without a mesh (or its group):
    the tensors themselves."""
    tensors = list(tensors)
    if not tensors or mesh is None or not mesh.distributed:
        return tensors
    flat = _bucket(tensors)
    all_reduce_sum_(flat, mesh)
    return bucket_views(flat.div_(mesh.size), tensors)


def reduce_loss_dict(loss_dict: Dict[str, torch.Tensor],
                     mesh: Optional[DataMesh]) -> Dict[str, torch.Tensor]:
    """The 0-dim losses, detached, as their means over the mesh's ranks (one
    bucket): with equal shards the global batch's means."""
    names = list(loss_dict)
    values = all_reduce_mean([loss_dict[k].detach() for k in names], mesh)
    return dict(zip(names, values))


def replicate_(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh]) -> None:
    """Set each tensor in place to the mesh's first rank's (one broadcast of
    a flat bucket per dtype and device); nothing without a group."""
    if mesh is None or not mesh.distributed:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = _bucket(group)
            buf = flat.cpu() if _via_host(flat, mesh) else flat
            dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
            for t, part in zip(group, bucket_views(buf.to(flat.device), group)):
                t.copy_(part)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return all_reduce_sum(t, mesh)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.mesh), None


def all_reduce_sum_grad(t: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """:func:`all_reduce_sum` that autograd differentiates: the gradient of
    every rank's input is the sum of the ranks' cotangents, so the ranks'
    backwards must run in step (each calls it once in the same order).
    ``t`` itself without a mesh."""
    if mesh is None:
        return t
    return _AllReduceSum.apply(t, mesh)


def batch_rows(local: int, mesh: Optional[DataMesh]) -> Optional[Tuple[int, int]]:
    """``(first, total)``: this rank's first row in the global batch of a
    batch of ``local`` rows a rank, and the global batch's rows; None
    without a mesh (one process).  A mesh of one rank gives ``(0, local)``."""
    if mesh is None:
        return None
    return mesh.index * local, mesh.size * local


def gather_batch(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """The ranks' ``x`` concatenated on axis 0 in mesh order, on every rank."""
    if not mesh.distributed:
        return x
    buf = x.cpu() if _via_host(x, mesh) else x.contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    return torch.cat(parts).to(x.device)


def gather_parts(t: torch.Tensor, mesh: DataMesh) -> list:
    """Every rank's ``t`` (same shape and dtype on each), in mesh order."""
    return list(gather_batch(t[None].to(mesh.device), mesh).cpu())


def barrier(mesh: DataMesh) -> None:
    """Wait for every rank of the mesh (a collective on its device)."""
    all_reduce_sum(torch.zeros(1, device=mesh.device), mesh)


def sync_generator(generator: Optional[torch.Generator], device: torch.device,
                   mesh: DataMesh) -> None:
    """Set ``generator`` (None: ``device``'s default one) to the mesh's first
    rank's state, on every rank: a torch generator is not replicated by
    construction as a JAX key is."""
    if not mesh.distributed:
        return
    if generator is None and device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        generator = torch.cuda.default_generators[index]
    elif generator is None:
        generator = torch.default_generator
    state = generator.get_state()
    # on NCCL the broadcast goes through the card (and makes the communicator)
    buf = state.to(mesh.device) if mesh.backend == "nccl" else state
    dist.broadcast(buf, src=mesh.ranks[0], group=mesh.group)
    generator.set_state(buf.cpu())
