"""K diffusion training micro-steps per call on the card, as replays of
captured CUDA graphs: the counterpart of the JAX trainer's
``make_train_step_scan`` (``prediff_tpu/training/diffusion_trainer.py``), a
``lax.scan`` of the step body in one dispatch.

One micro-step is captured per kind, ``"accumulate"`` (the optimizer only
adds the micro-gradient to its running mean) and ``"update"`` (it adds it,
clips, steps AdamW; every micro-step with ``accum_steps`` 1), and each
micro-step of a call replays its kind's graph.  A graph reads what changes
from micro-step to micro-step out of static buffers (:class:`ScanBuffers`),
which the host fills before each replay, without a sync:

* the micro-batch, copied from the call's (K, B, ...) stack, which crosses
  to the card once a call;
* the draws of the step's generator (``diffusion_trainer.step_generator``):
  the posterior's noise, t and the noise, drawn eagerly in the eager step's
  order (``LatentDiffusion.training_draws``; on a mesh the rank's rows of
  the global batch's draws, ``parallel.batch_rows``), so they are its bits;
* the dropout seed (``diffusion_trainer.step_dropout_seed``) as a device seed,
  which the dropout kernels read from its address (``ops/dropout.py``);
* the device scalars of the train state (``EmaTrainState.load_scalars``): the
  learning rate, the accumulation's divisor, the EMA's weight and, with a
  ``state_dtype``, ``AdamStateDtype``'s step size, decay and bias correction.

Inside a capture the bf16 weight copies of ``ops/weights.py`` are recast on
every call (``weights.recasting``), so each replay casts the parameters that
the replayed optimizer steps moved into the layouts the tensor maps name; the
graphs keep those layouts.  The host keeps the counters (``state.step``,
the optimizer's ``count`` and ``mini_step``: ``EmaTrainState.counters``) and
bumps the version counters a replay moves (``EmaTrainState.advance``).
Under ``remat_unet`` the checkpointed segments' recompute runs inside the
captured backward, on the graph's pool.

A micro-step is the trainer's two parts, ``grads(state, buffers)`` (the
loss and this rank's gradients and loss dict) and ``apply(state, grads,
loss_dict)`` (the norms, the optimizer and the EMA on the state's loaded
device scalars), with the reduction between them.  On a mesh
(``parallel.DataMesh``) that reduction is the eager step's
(``parallel.all_reduce_mean``, ``parallel.reduce_loss_dict``).  Without one,
or on NCCL, the micro-step is one graph, the all-reduces captured inside it
(an eager collective makes the communicator before the first capture).
On gloo the all-reduce passes through the host, which a graph cannot
capture, so each micro-step is split in two graphs:
``"grads"`` (the loss and this rank's gradients, written with the losses
into one static flat bucket, shared by both kinds), then the host all-reduce
of that bucket (eager: one copy each way, one sync, each part reduced as the
eager step reduces it, ``parallel.all_reduce_sum_``), then the kind's graph
(the mean, the norms, the optimizer and the EMA).

Capture (``diffusion/graphs.capture_graph``): the first run of a graph's
work runs eagerly on a side stream, a real micro-step (or part) of the run
(it builds the kernels, lays out every weight, makes the optimizer's state),
then the same work is captured with the host's counters set back to where
they stood, and restored after; the collector is off during the capture.
Every graph of a :class:`ScanGraphs` shares one pool.  A capture that fails
raises: there is no eager fallback.  The graphs hold the addresses of every
tensor of the state, of the models and of the buffers; :meth:`ScanGraphs.key`
names them and the mesh's ``key``, and a call whose key differs (a restored
checkpoint's new optimizer state, another batch shape) captures anew.  The
optimizer's version bumps do not invalidate.  Launch counts: each replay adds
its graph's launches to the kernels' counters, as ``diffusion/graphs.py``
does.  On a CPU device every micro-step runs the same code on the same
buffers eagerly (no capture; on a mesh the same two parts around the same
reduction): the tests' way through this code.
"""
import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..diffusion.graphs import capture_graph, launches_by_name, pool_bytes, replay
from ..ops import weights
from ..ops.dropout import device_seed, signed64
from ..parallel.mesh import (DataMesh, all_reduce_mean, all_reduce_sum_, barrier, batch_rows,
                             bucket_sizes, bucket_views, reduce_loss_dict)


@dataclass
class ScanBuffers:
    """What a captured micro-step reads and writes: the micro-batch ``x``,
    ``y``, the draws ``eps`` / ``t`` / ``noise``, the device ``seed``, and
    ``metrics``, the loss dict's values in ``names``' order.  Split in two
    graphs (a gloo mesh): ``flat``, the bucket of this rank's gradients
    (shaped ``shapes``) then that of its losses (``loss_names``), laid out as
    ``parallel.all_reduce_mean`` lays out each (``parallel.bucket_views``), of
    sizes ``parts``, reduced between the graphs through ``host``, its pinned
    twin."""
    x: torch.Tensor
    y: torch.Tensor
    eps: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    seed: torch.Tensor
    metrics: Optional[torch.Tensor] = None
    names: Optional[List[str]] = None
    flat: Optional[torch.Tensor] = None
    host: Optional[torch.Tensor] = None
    parts: Optional[List[int]] = None
    shapes: Optional[List[torch.Size]] = None
    loss_names: Optional[List[str]] = None


class ScanGraphs:
    """The captured micro-steps of one trainer: ``draws(generator, batch,
    out[, rows=])`` fills the draws, whose shapes ``draw_shapes(batch)``
    gives; ``mesh`` the ranks the micro-steps reduce over.  The micro-step's
    two parts come with each call and are not kept: the trainer that keeps
    these graphs and the graphs' pool go with no cycle."""

    def __init__(self, draws: Callable, draw_shapes: Callable, device: torch.device,
                 mesh: Optional[DataMesh] = None):
        self.draws = draws
        self.draw_shapes = draw_shapes
        self.device = device
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        # gloo's all-reduce goes through the host: two graphs a micro-step around it
        self.split = self.mesh is not None and self.mesh.backend != "nccl"
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, list]] = {}
        self.buffers: Optional[ScanBuffers] = None
        self._key: Optional[tuple] = None
        self._pool = None
        self._layouts: list = []     # the bf16 layouts the graphs write and read
        self.captures = 0
        self.capture_seconds = 0.0
        # lists: each replay appends (graph key, start, stop), its CUDA events
        # (device time), each host all-reduce of a split micro-step its ms (synchronized)
        self.timing: Optional[list] = None
        self.reduce_ms: Optional[list] = None

    @staticmethod
    def key(state, modules, x: torch.Tensor, y: torch.Tensor, extra=(),
            mesh: Optional[DataMesh] = None) -> tuple:
        """What the graphs are bound to: the address of every tensor of the
        state (parameters, shadow, optimizer state, accumulated gradients,
        device scalars) and of the modules' parameters and buffers, the
        micro-batch's shapes and dtypes, the mesh's ``key()`` and ``extra``."""
        tensors = state.tensors() + state.scalar_tensors()
        for m in modules:
            tensors += list(m.parameters()) + list(m.buffers())
        return (tuple(t.data_ptr() for t in tensors),
                tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
                None if mesh is None else mesh.key(), tuple(extra))

    def _bind(self, key: tuple, x: torch.Tensor, y: torch.Tensor) -> None:
        """Drop every graph unless ``key`` is the one they were captured
        under; make the buffers for this key."""
        if key == self._key:
            return
        self.graphs.clear()
        self._layouts = []
        self._pool = None
        B = x.shape[0]
        eps, t, noise = self.draw_shapes(B)
        dev = self.device
        self.buffers = ScanBuffers(
            x=torch.empty(x.shape, dtype=x.dtype, device=dev),
            y=torch.empty(y.shape, dtype=y.dtype, device=dev),
            eps=torch.empty(eps, dtype=torch.float32, device=dev),
            t=torch.empty(t, dtype=torch.int64, device=dev),
            noise=torch.empty(noise, dtype=torch.float32, device=dev),
            seed=device_seed(0, dev))
        if self.mesh is not None and not self.split and dev.type == "cuda":
            barrier(self.mesh)   # NCCL: the communicator exists before any capture
        self._key = key

    def _capture(self, work: Callable[[], None], name: str, state) -> None:
        """``work`` eagerly (a real micro-step or part), then captured from
        the same counters into the graph ``name``."""
        before = state.counters()
        after = []

        def step():
            if not after:       # the eager run: the real work
                work()
                after.append(state.counters())
                return
            state.set_counters(before)
            try:
                with weights.recasting() as touched:
                    work()
                self._layouts += touched
            finally:
                state.set_counters(after[0])

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, deltas, seconds = capture_graph(step, self.device, self._pool)
        self.graphs[name] = (graph, deltas)
        self.captures += 1
        self.capture_seconds += seconds

    def _step(self, name: str, work: Callable[[], None], state, advance: bool) -> None:
        """The graph ``name``'s work: eagerly on a CPU device, else its
        replay (``advance``: then the host's counters past the micro-step),
        or its capture the first time."""
        if self.device.type != "cuda":
            work()
        elif name in self.graphs:
            if self.timing is not None:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                replay(*self.graphs[name])
                stop.record()
                self.timing.append((name, start, stop))
            else:
                replay(*self.graphs[name])
            if advance:
                state.advance()
        else:
            self._capture(work, name, state)

    def _store(self, loss_dict: Dict[str, torch.Tensor]) -> None:
        b = self.buffers
        if b.names is None:
            b.names = list(loss_dict)
            b.metrics = torch.empty(len(b.names), dtype=torch.float32, device=self.device)
        b.metrics.copy_(torch.stack([loss_dict[k].detach().float().reshape(())
                                     for k in b.names]))

    def _run_whole(self, grads: Callable, apply: Callable, state) -> None:
        """A micro-step in one graph: the gradients, their reduction over the
        mesh (none without one), the update."""
        g, loss_dict = grads(state, self.buffers)
        self._store(apply(state, all_reduce_mean(g, self.mesh),
                          reduce_loss_dict(loss_dict, self.mesh)))

    def _run_grads(self, grads: Callable, state) -> None:
        """The first part of a split micro-step: this rank's gradients and
        losses into the flat bucket."""
        b = self.buffers
        grads, loss_dict = grads(state, b)
        if b.flat is None:
            b.loss_names, b.shapes = list(loss_dict), [g.shape for g in grads]
            b.parts = [sum(bucket_sizes(b.shapes)), sum(bucket_sizes(self._loss_shapes()))]
            # zeros: the padding between the bucket's tensors stays 0
            b.flat = torch.zeros(sum(b.parts), dtype=torch.float32, device=self.device)
            if self.device.type == "cuda":
                b.host = torch.empty(b.flat.shape, dtype=b.flat.dtype, pin_memory=True)
        gflat, lflat = b.flat.split(b.parts)
        views = bucket_views(gflat, b.shapes) + bucket_views(lflat, self._loss_shapes())
        torch._foreach_copy_(views, [g.detach() for g in grads]
                             + [loss_dict[k].detach() for k in b.loss_names])

    def _loss_shapes(self) -> list:
        return [torch.Size([])] * len(self.buffers.loss_names)

    def _reduce(self) -> None:
        """The host all-reduce of a split micro-step's bucket, eagerly: each
        part summed over the ranks as the eager step sums it."""
        b = self.buffers
        timed = self.reduce_ms is not None and self.device.type == "cuda"
        if timed:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        all_reduce_sum_(b.flat, self.mesh, b.parts, b.host)
        if timed:
            torch.cuda.synchronize(self.device)
            self.reduce_ms.append(1e3 * (time.perf_counter() - t0))

    def _run_apply(self, apply: Callable, state) -> None:
        """The second part of a split micro-step: the means of the reduced
        sums, then the norms, the optimizer and the EMA on them."""
        b = self.buffers
        gflat, lflat = b.flat.split(b.parts)
        grads = bucket_views(gflat.div_(self.mesh.size), b.shapes)
        losses = dict(zip(b.loss_names, bucket_views(lflat.div_(self.mesh.size),
                                                     self._loss_shapes())))
        self._store(apply(state, grads, losses))

    def run(self, grads: Callable, apply: Callable, state, seeds: List[int],
            generators: List[torch.Generator], xs: torch.Tensor, ys: torch.Tensor,
            key: Callable[[], tuple]) -> Dict[str, torch.Tensor]:
        """K micro-steps of ``grads`` then ``apply`` (the module docstring)
        on the (K, B, ...) stacks ``xs``, ``ys``
        (on the card; on a mesh this rank's rows), the k-th with dropout seed
        ``seeds[k]`` and draws from ``generators[k]``; returns the loss dicts
        stacked (K,), on the card.  ``key()`` gives :meth:`key` of the state
        as it stands: the graphs are bound to its value after the call (a
        first update makes the optimizer's moments)."""
        K = xs.shape[0]
        self._bind(key(), xs[0], ys[0])
        b = self.buffers
        B = b.x.shape[0]
        rows = batch_rows(B, self.mesh)
        draw_kw = {} if rows is None else {"rows": rows}
        out = None
        for k in range(K):
            kind = "update" if state.tx.updates_next() else "accumulate"
            self.draws(generators[k], B, (b.eps, b.t, b.noise), **draw_kw)
            b.seed.fill_(signed64(seeds[k]))
            b.x.copy_(xs[k])
            b.y.copy_(ys[k])
            state.load_scalars()
            if self.split:
                self._step("grads", lambda: self._run_grads(grads, state), state, advance=False)
                self._reduce()
                self._step(kind, lambda: self._run_apply(apply, state), state, advance=True)
            else:
                self._step(kind, lambda: self._run_whole(grads, apply, state), state,
                           advance=True)
            if out is None:
                out = torch.empty((K, len(b.names)), dtype=torch.float32, device=self.device)
            out[k].copy_(b.metrics)
        self._key = key()
        return {name: out[:, i] for i, name in enumerate(b.names)}

    def launches_per_replay(self) -> Dict[str, Dict[str, int]]:
        """Per graph (micro-step kind; ``"grads"`` too when split), each
        wrapper's launches a replay adds."""
        return {kind: launches_by_name(deltas) for kind, (_, deltas) in self.graphs.items()}

    def pool_bytes(self) -> int:
        """Bytes the graphs' pool holds on the card."""
        return pool_bytes(self._pool)

