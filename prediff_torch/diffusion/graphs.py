"""The reverse chain on the card as captured CUDA graphs: the counterpart of
the JAX package's ``_build_sample_fn`` and its ``_jit_cache``.

The JAX package compiles a whole forecast into one program per static key
(``prediff_tpu/diffusion/latent_diffusion.py:376-552``, ``:598-607``).  Here
one reverse step is captured per static key and step kind (guided or not:
``guidance_every_k > 1`` alternates them, as ``lax.cond`` does there) and
replayed once per step.  A step reads everything that changes from step to
step out of static buffers (:class:`StepBuffers`): the latent z, which the
step overwrites with its result, t (or the DDIM index), whose schedule
values the step gathers on the device, and the noise, which the host draws
from the caller's generator into its buffer before each replay, in the
order the eager chain draws it.  The context encode and the decode run once
a forecast, eagerly.

Capture: the first step of each kind runs eagerly on a side stream (it is a
real step of the chain: it builds every library, lays out every bf16 weight
and TMA map of ``ops/weights.py``, sets every kernel attribute), then the
same step is captured; it runs from the next step on as a replay.  Every
graph of a cache shares one memory pool: they never replay at once, and
all they pass on lies in the static buffers, outside the pool.  A capture
that fails raises.

A graph keeps the weight addresses and bf16 layouts it was captured with.
:meth:`StepGraphCache.validate` compares the ``(data_ptr, _version)`` of
every parameter and buffer of the captured modules with the snapshot of the
captures, once per forecast, and drops every graph when one has moved.  An
update through ``.data`` bypasses the version counter and is not seen, as
in ``ops/weights.py``.

Every graph of :func:`capture_graph` that ran a matrix product holds the
address of PyTorch's cuBLAS workspace for the stream it was captured on,
and the warm-ups' side stream and the eager steps' stream keep one each,
made when a stream first needs one, from the cache: made in the middle of a
step, a workspace splits a large cached block of that step's activations and
keeps its whole segment reserved.  :func:`release_workspaces` frees them
all, once no such graph is alive.

The kernels' ``.launches`` counters (and ``.bf16_launches``, their bf16
forms', and the FFN kernels' ``.relu_launches`` / ``.leaky_launches`` /
``.silu_launches``) tick in Python, once per wrapper call; a capture would count one
step however often it is replayed.  So the counts a capture adds are taken
back and kept as the graph's launches per replay, and each replay adds them
again: the counters still count the kernels' launches on the card.
"""
import gc
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.precision import versions


@dataclass
class StepBuffers:
    """What a reverse step reads and writes.  ``z`` takes the step's result
    in place; ``t`` (B,) int64 holds the DDPM t or the DDIM index; ``noise``
    the step's noise and ``noise2`` the mask's (None where the chain draws
    none); the rest stay fixed through a chain.  On a mesh the buffers hold
    this rank's rows, and ``noise`` / ``noise2`` are views of this rank's
    rows of ``noise_all`` / ``noise2_all``, the whole batch's draws, which the
    host fills; without one ``noise_all`` is ``noise`` itself."""
    z: torch.Tensor
    t: torch.Tensor
    noise: Optional[torch.Tensor]
    noise2: Optional[torch.Tensor]
    zc: torch.Tensor
    y: torch.Tensor
    avg_x_gt: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    x0: Optional[torch.Tensor]
    noise_all: Optional[torch.Tensor] = None
    noise2_all: Optional[torch.Tensor] = None


COUNTERS = ("launches", "bf16_launches", "relu_launches", "leaky_launches", "silu_launches")


def launch_counters() -> List[Callable]:
    """Every kernel wrapper with a ``.launches`` counter."""
    from ..ops import attention, conv3d, ffn, groupnorm, resblock

    found = {}
    for module in (attention, conv3d, ffn, groupnorm, resblock):
        for fn in vars(module).values():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                found[id(fn)] = fn
    return list(found.values())


def _counts() -> List[Tuple[Callable, str, int]]:
    """(wrapper, counter, value) of every counter of every kernel wrapper."""
    return [(fn, attr, getattr(fn, attr)) for fn in launch_counters() for attr in COUNTERS
            if hasattr(fn, attr)]


class StepGraphs:
    """The captured steps of one static key: its plan, its static buffers
    and a graph per step kind with its launches per replay."""

    def __init__(self, cache: "StepGraphCache", plan, buffers: StepBuffers):
        self.cache = cache
        self.plan = plan
        self.buffers = buffers
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, list]] = {}

    def run(self, kind: Hashable, step: Callable[[], None]) -> None:
        """One step of ``kind``: its first one eagerly, then captured, every
        later one by replay."""
        entry = self.graphs.get(kind)
        if entry is None:
            self.graphs[kind] = self.cache.capture(step, self.buffers.z.device)
            return
        replay(*entry)

    def launches_per_replay(self) -> Dict[Hashable, Dict[str, int]]:
        """Per step kind, each wrapper's launches a replay adds (its bf16
        form's under ``<name>.bf16``, an FFN activation's under
        ``<name>.<activation>``)."""
        return {kind: launches_by_name(deltas) for kind, (_, deltas) in self.graphs.items()}


class StepGraphCache:
    """Captured steps by static key, for the modules ``modules()`` returns;
    the graphs of every key share one memory pool."""

    def __init__(self, modules: Callable[[], Sequence[nn.Module]]):
        self._modules = modules
        self._entries: Dict[Hashable, StepGraphs] = {}
        self._snapshot: Optional[tuple] = None
        self._pool = None
        self.captures = 0
        self.capture_seconds = 0.0

    def __len__(self) -> int:
        return len(self._entries)

    def snapshot(self) -> tuple:
        """``(data_ptr, _version)`` of every parameter and buffer the steps read."""
        return tuple(v for m in self._modules() for v in versions(m))

    def validate(self) -> bool:
        """Drop every graph if a parameter or buffer moved since the
        captures; True if they were dropped.  Once per forecast."""
        now = self.snapshot()
        stale = self._snapshot is not None and now != self._snapshot
        if stale:
            self._entries.clear()
            self._pool = None
        self._snapshot = now
        return stale

    def entry(self, key: Hashable, make: Callable[[], tuple]) -> Tuple[StepGraphs, bool]:
        """The entry of ``key`` and whether it is new; ``make()`` gives a new
        one's ``(plan, buffers)``."""
        found = self._entries.get(key)
        if found is not None:
            return found, False
        found = self._entries[key] = StepGraphs(self, *make())
        return found, True

    def entries(self) -> List[StepGraphs]:
        return list(self._entries.values())

    def capture(self, step: Callable[[], None], device: torch.device):
        """Run ``step`` eagerly on a side stream, then capture it into a
        graph of this cache's pool; returns the graph and its launches per
        replay."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, deltas, seconds = capture_graph(step, device, self._pool)
        self.capture_seconds += seconds
        self.captures += 1
        return graph, deltas

    def pool_bytes(self) -> int:
        """Bytes the shared pool holds on the card (0 before a capture)."""
        return pool_bytes(self._pool)


_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}
_LIVE: "weakref.WeakSet" = weakref.WeakSet()   # the graphs capture_graph made, while alive


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """One side stream per device for every warm-up: the memory the caching
    allocator keeps for a stream's blocks is kept for one stream, not one per
    capture."""
    device = torch.device(device)
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def capture_graph(step: Callable[[], None], device: torch.device, pool):
    """Run ``step`` eagerly on a side stream, then capture it into a graph
    of ``pool``; returns the graph, its launches per replay (the counters'
    moves during the capture, which are taken back) and the capture's
    seconds.  A capture that fails raises."""
    current = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        step()
    current.wait_stream(side)
    before = _counts()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    # no garbage collection during the capture: a dead reference cycle
    # freed there (a profiler's results, say) may call the CUDA runtime in
    # a way a capture forbids and invalidate it; collect before it instead
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            step()
    finally:
        if collecting:
            gc.enable()
        deltas = [(fn, attr, getattr(fn, attr) - n) for fn, attr, n in before
                  if getattr(fn, attr) != n]
        for fn, attr, n in before:
            setattr(fn, attr, n)
    _LIVE.add(graph)
    return graph, deltas, time.perf_counter() - t0


def replay(graph, deltas) -> None:
    """One replay of ``graph``, its launches added to the counters."""
    graph.replay()
    for fn, attr, n in deltas:
        setattr(fn, attr, getattr(fn, attr) + n)


def launches_by_name(deltas) -> Dict[str, int]:
    """A graph's launches per replay by wrapper name (a bf16 form's under
    ``<name>.bf16``, an FFN activation's under ``<name>.<activation>``)."""
    return {fn.__name__ + ("" if attr == "launches" else "." + attr[:-len("_launches")]): n
            for fn, attr, n in deltas}


def pool_bytes(pool) -> int:
    """Bytes a graph pool holds on the card (0 for None)."""
    if pool is None:
        return 0
    segments = torch.cuda.memory._snapshot()["segments"]
    return sum(s["total_size"] for s in segments
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


def release_workspaces() -> None:
    """Free PyTorch's cuBLAS workspaces (module docstring), so that
    ``torch.cuda.empty_cache`` can give back the segments they keep; the
    next product makes its own.  Every graph of :func:`capture_graph` that
    ran a product replays into its stream's workspace, so this raises while
    any of them is alive: call it once the pipelines and trainers that hold
    graphs are dropped."""
    gc.collect()
    if len(_LIVE):
        raise RuntimeError(f"release_workspaces: {len(_LIVE)} captured graphs are alive and "
                           "hold the cuBLAS workspaces' addresses")
    torch._C._cuda_clearCublasWorkspaces()
