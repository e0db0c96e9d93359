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
  order (``LatentDiffusion.training_draws``), so they are its bits;
* the dropout seed (``diffusion_trainer.step_dropout_seed``) as a device seed,
  which the dropout kernels read from its address (``ops/dropout.py``);
* the device scalars of the train state (``EmaTrainState.load_scalars``): the
  learning rate, the accumulation's divisor and the EMA's weight.

Inside a capture the bf16 weight copies of ``ops/weights.py`` are recast on
every call (``weights.recasting``), so each replay casts the parameters that
the replayed optimizer steps moved into the layouts the tensor maps name; the
graphs keep those layouts.  The host keeps the counters (``state.step``,
the optimizer's ``count`` and ``mini_step``) and bumps the version counters a
replay moves (``EmaTrainState.advance``).

Capture (``diffusion/graphs.capture_graph``): the first micro-step of a kind
runs eagerly on a side stream, a real micro-step of the run (it builds the
kernels, lays out every weight, makes the optimizer's state), then the same
micro-step is captured with the host's counters set back to where they
stood, and restored after; the collector is off during the capture.  Every
graph of a :class:`ScanGraphs` shares one pool.  A capture that fails raises:
there is no eager fallback.  The graphs hold the addresses of every tensor
of the state, of the models and of the buffers; :meth:`ScanGraphs.key` names
them, and a call whose key differs (a restored checkpoint's new optimizer
state, another batch shape) captures anew.  The optimizer's version bumps do
not invalidate.  Launch counts: each replay adds its graph's launches to the
kernels' counters, as ``diffusion/graphs.py`` does.  On a CPU device every
micro-step runs the same body on the same buffers eagerly (no capture): the
tests' way through this code.
"""
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from ..diffusion.graphs import capture_graph, launches_by_name, pool_bytes, replay
from ..ops import weights
from ..ops.dropout import device_seed, signed64


@dataclass
class ScanBuffers:
    """What a captured micro-step reads and writes: the micro-batch ``x``,
    ``y``, the draws ``eps`` / ``t`` / ``noise``, the device ``seed``, and
    ``metrics``, the loss dict's values in ``names``' order."""
    x: torch.Tensor
    y: torch.Tensor
    eps: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    seed: torch.Tensor
    metrics: Optional[torch.Tensor] = None
    names: Optional[List[str]] = None


class ScanGraphs:
    """The captured micro-steps of one trainer: ``draws(generator, batch,
    out)`` fills the draws, whose shapes ``draw_shapes(batch)`` gives; the
    micro-step itself, ``body(state, buffers)`` (loss, gradients,
    ``EmaTrainState.apply_loaded`` on the state's loaded device scalars,
    returning the loss dict), comes with each call and is not kept: the
    trainer that keeps these graphs and the graphs' pool go with no cycle."""

    def __init__(self, draws: Callable, draw_shapes: Callable, device: torch.device):
        self.draws = draws
        self.draw_shapes = draw_shapes
        self.device = device
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, list]] = {}
        self.buffers: Optional[ScanBuffers] = None
        self._key: Optional[tuple] = None
        self._pool = None
        self._layouts: list = []     # the bf16 layouts the graphs write and read
        self.captures = 0
        self.capture_seconds = 0.0
        # a list: each replay appends (kind, start, stop), its CUDA events (device time)
        self.timing: Optional[list] = None

    @staticmethod
    def key(state, modules, x: torch.Tensor, y: torch.Tensor, extra=()) -> tuple:
        """What the graphs are bound to: the address of every tensor of the
        state (parameters, shadow, optimizer state, accumulated gradients,
        device scalars) and of the modules' parameters and buffers, the
        micro-batch's shapes and dtypes, and ``extra``."""
        tensors = state.tensors() + [state.tx.lr_t, state.tx.div_t, state.ema_w]
        for m in modules:
            tensors += list(m.parameters()) + list(m.buffers())
        return (tuple(t.data_ptr() for t in tensors),
                tuple(x.shape), x.dtype, tuple(y.shape), y.dtype, tuple(extra))

    def _bind(self, key: tuple, state, x: torch.Tensor, y: torch.Tensor) -> None:
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
        self._key = key

    def _capture(self, body: Callable, kind: str, state) -> None:
        """The micro-step of ``kind`` eagerly (a real one), then captured
        from the same counters."""
        before = (state.step, state.tx.count, state.tx.mini_step)
        after = []

        def step():
            if not after:       # the eager run: the real micro-step
                self._run_body(body, state)
                after.append((state.step, state.tx.count, state.tx.mini_step))
                return
            state.step, state.tx.count, state.tx.mini_step = before
            try:
                with weights.recasting() as touched:
                    self._run_body(body, state)
                self._layouts += touched
            finally:
                state.step, state.tx.count, state.tx.mini_step = after[0]

        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, deltas, seconds = capture_graph(step, self.device, self._pool)
        self.graphs[kind] = (graph, deltas)
        self.captures += 1
        self.capture_seconds += seconds

    def _run_body(self, body: Callable, state) -> None:
        b = self.buffers
        loss_dict = body(state, b)
        if b.names is None:
            b.names = list(loss_dict)
            b.metrics = torch.empty(len(b.names), dtype=torch.float32, device=self.device)
        b.metrics.copy_(torch.stack([loss_dict[k].detach().float().reshape(())
                                     for k in b.names]))

    def run(self, body: Callable, state, seeds: List[int], generators: List[torch.Generator],
            xs: torch.Tensor, ys: torch.Tensor, key: Callable[[], tuple]
            ) -> Dict[str, torch.Tensor]:
        """K micro-steps of ``body`` on the (K, B, ...) stacks ``xs``, ``ys``
        (on the card), the k-th with dropout seed ``seeds[k]`` and draws from
        ``generators[k]``; returns the loss dicts stacked (K,), on the card.
        ``key()`` gives :meth:`key` of the state as it stands: the graphs are
        bound to its value after the call (a first update makes the
        optimizer's moments)."""
        K = xs.shape[0]
        self._bind(key(), state, xs[0], ys[0])
        b = self.buffers
        out = None
        for k in range(K):
            kind = "update" if state.tx.updates_next() else "accumulate"
            self.draws(generators[k], b.x.shape[0], (b.eps, b.t, b.noise))
            b.seed.fill_(signed64(seeds[k]))
            b.x.copy_(xs[k])
            b.y.copy_(ys[k])
            state.load_scalars()
            if self.device.type != "cuda":    # the CPU: the same micro-step, eagerly
                self._run_body(body, state)
            elif kind in self.graphs:
                if self.timing is not None:
                    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    replay(*self.graphs[kind])
                    stop.record()
                    self.timing.append((kind, start, stop))
                else:
                    replay(*self.graphs[kind])
                state.advance()
            else:
                self._capture(body, kind, state)
            if out is None:
                out = torch.empty((K, len(b.names)), dtype=torch.float32, device=self.device)
            out[k].copy_(b.metrics)
        self._key = key()
        return {name: out[:, i] for i, name in enumerate(b.names)}

    def launches_per_replay(self) -> Dict[str, Dict[str, int]]:
        """Per micro-step kind, each wrapper's launches a replay adds."""
        return {kind: launches_by_name(deltas) for kind, (_, deltas) in self.graphs.items()}

    def pool_bytes(self) -> int:
        """Bytes the graphs' pool holds on the card."""
        return pool_bytes(self._pool)
