"""Tracing and profiling helpers: a profiler scope, named ranges, a step
timer, per-leaf gradient norms and a count of the kernel wrappers' calls.

Counterpart of ``prediff_tpu/utils/profiling.py``, with its names where they
fit.  Usage::

    with trace("/tmp/torch-trace"):          # view in TensorBoard / Perfetto
        with annotate("train_step"):
            train_step(...)

    timer = StepTimer(device="cuda")          # synchronizes on enter and exit
    with timer:
        out = step(...)
    print(timer.summary())

    count_kernel_launches(unet, x, t, cond)   # {"fused_ffn": 48, ...}

No program has to call them; ``chip_smoke.py`` drives each on the card.
"""
import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import _build

# the kernel wrappers of prediff_torch/ops -> the name of the TPU kernel each
# replaces (the ``name`` of its ``pl.pallas_call`` in prediff_tpu/ops, which
# the JAX ``count_pallas_calls`` reports): a dropout form shares its kernel's
# name where the JAX package takes the same pallas_call with a seed
TPU_KERNELS = {
    "fused_groupnorm_silu": "fused_groupnorm_silu",
    "fused_groupnorm_silu_bwd_full": "fused_groupnorm_silu_bwd_full",
    "fused_ffn": "fused_ffn",
    "fused_ffn_dropout": "fused_ffn_dropout",
    "fused_ffn_bwd_dx": "fused_ffn_bwd_dx",
    "fused_ffn_bwd_full": "fused_ffn_bwd_full",
    "fused_ffn_dropout_bwd_full": "fused_ffn_dropout_bwd_full",
    "fused_axial_attention": "fused_axial_attention_5d",
    "fused_axial_attention_dropout": "fused_axial_attention_5d",
    "fused_axial_attention_bwd_dx": "fused_axial_attention_5d_bwd_dx",
    "fused_axial_attention_bwd_full": "fused_axial_attention_5d_bwd_full",
    "fused_axial_attention_dropout_bwd_full": "fused_axial_attention_5d_bwd_full",
    "fused_cuboid_attention_layer": "fused_cuboid_attention_layer_v4",
    "fused_cuboid_attention_layer_dropout": "fused_cuboid_attention_layer_v4",
    "fused_cuboid_attention_layer_bwd_dx": "fused_cuboid_attention_layer_v4_bwd_dx",
    "fused_cuboid_attention_layer_bwd_full": "fused_cuboid_attention_layer_v4_bwd_full",
    "fused_cuboid_attention_layer_dropout_bwd_full": "fused_cuboid_attention_layer_v4_bwd_full",
    "fused_cuboid_attention_grouped": "fused_cuboid_attention_grouped",
    "fused_resblock_fwd": "fused_resblock",
    "fused_resblock_bwd": "_fused_resblock_bwd",
    "conv3x3x3_forward": "fused_conv3x3x3",
    "conv3x3x3_dx": "fused_conv3x3x3",
    "fused_cuboid_attention": "fused_cuboid_attention",
    "fused_cuboid_attention_layer_v3": "fused_cuboid_attention_layer",
}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` scope over the CPU, and over CUDA when a card is
    present; at its end a Chrome / TensorBoard trace (``*.pt.trace.json``) is
    written into ``log_dir``.  Yields the profiler (``key_averages()``)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named range in the profiler's trace (``record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with a percentile summary.  ``device``: a CUDA
    device that is synchronized on enter and on exit, so that a step's time
    holds its work on the card (what a JAX caller's ``block_until_ready``
    adds); None times the host alone."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "max_s": float(arr.max()),
            "steps_per_sec": float(1.0 / arr.mean()),
            "n": len(arr),
        }


def tree_grad_norms(grads) -> Dict[str, float]:
    """Per-leaf L2 norms of a nested dict of tensors (or a flat name ->
    tensor dict), keyed by the path joined with ``/``; one host transfer."""
    names, leaves = [], []

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        else:
            names.append(prefix[:-1])
            leaves.append(torch.as_tensor(tree).detach().float())

    walk(grads)
    if not leaves:
        return {}
    device = leaves[0].device
    norms = torch.stack([n.to(device) for n in torch._foreach_norm(leaves)]).tolist()
    return dict(zip(names, norms))


def count_kernel_launches(fn, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and return ``{TPU kernel name:
    calls}`` over the port's kernel wrappers, counted at each wrapper's
    dispatch point whether it launches its kernel (CUDA tensors) or its plain
    version (CPU tensors); library code gives ``{}``.  Raises if a call on a
    CUDA tensor did not launch its kernel.  Unlike the JAX
    ``count_pallas_calls``, which walks a static jaxpr, this counts the calls
    as they run: a loop body counts once per iteration, and a captured CUDA
    graph's replay calls no wrapper."""
    scope = {"calls": {}, "card": {}, "launched": {}}
    _build.SCOPES.append(scope)
    try:
        fn(*args, **kwargs)
    finally:
        _build.SCOPES.remove(scope)
    short = {k: n - scope["launched"].get(k, 0) for k, n in scope["card"].items()
             if n != scope["launched"].get(k, 0)}
    if short:
        raise RuntimeError(f"calls on the card that did not launch their kernel: {short}")
    out: Dict[str, int] = {}
    for name, n in scope["calls"].items():
        tpu = TPU_KERNELS[name]
        out[tpu] = out.get(tpu, 0) + n
    return out
