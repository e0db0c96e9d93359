#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card
    python3 chip_smoke.py --log build/chip_smoke.jsonl   # also keep every line there

Phases, one JSON line each: the card; the kernels' build from
``prediff_torch/csrc``, in a thread of its own while the phases that need no
kernel but GN's run (the ``tiny_*`` phases, ``cli_learning_check``, the
randomized models and the kernel cases on the CPU; a GN launch waits for its
source); each hand-written kernel against its plain PyTorch
version at every shape the UNet (forecasting at B=1, training at the
micro-batch size) and the alignment net give it, with times; ``bwd_split``,
each launch's share of the all-gradients backwards at the training shapes
(GroupNorm+SiLU's too), of the general layer's dx and of the resblock;
the ``tiny_*`` phases on ``configs/tiny_smoke.yaml``, whose widths (16, 32)
every FFN, attention and resblock kernel refuses: a forecast, a guidance
shift and a training step at dropout 0 and 0.1, card against CPU, with no
launch of those kernels; ``kernel_switches``, models built with each
``use_pallas_*`` switch False launching none of its kernels (with "auto"
each);
a full-width UNet forward on the card (kernels) against the same forward on
the CPU (plain versions) with randomized weights; the guidance shift of the
full-width alignment net on the card against the CPU's; then three chains
through ``PreDiffPredictor.predict``, each with the kernels' launch counts
set to 0 just before it and read just after: the ``CHAIN_STEPS``-step
unguided DDPM forecast, the same guided and the 50-step guided DDIM
forecast (VAE encode, the steps, VAE decode).  Each chain's steps replay
captured CUDA graphs (``prediff_torch/diffusion/graphs.py``): every chain
runs twice from one seed, eager and on graphs (the graph run captures; the
order alternates by chain), with exact launch counts in each, bit-equal
outputs, the step loop's ms per step timed apart from the encode and the
decode, its capture seconds, pool bytes, launches per replay and device
time per step by replay; a ``graph_chains`` line gathers them before the
``kernels`` line.  Profiles of a UNet forward and of a guided step;
``graph_recapture``: a repeated forecast replays without capturing, then an
in-place weight update makes the next one capture anew.  Then the same on the
``video_swin_1x8`` pattern
(``swin_*`` phases: shifted 1x8x8 windows in the UNet and the alignment net):
the general cuboid layer, its input gradient, its all-gradients backward and
their dropout forms and the grouped masked core against their plain versions
at its shapes (forecasting and training) and at vol 128, 256 and 1536, a
UNet forward and a guidance shift card against CPU, the ``CHAIN_STEPS``-step
unguided and guided DDPM forecasts with exact launch counts, profiles; and for each
of ``PATTERN_CHECKS`` (depth [1,1]) a UNet forward and a guidance shift card
against CPU with exact launch counts.  Then
training.  ``train_rate0``, with the dropout rates at 0 and the UNet cut to
depth [1,1]: one loss and backward on the card (kernels) against the CPU
(plain, f32), then one accumulated optimizer step
through ``DiffusionTrainer.train_step``, which launches the all-gradients
kernels without dropout.  At the recipe's own rates (0.1): ``train_grads``,
with the UNet cut to depth [1,1], one loss and backward of the UNet on the
card (the dropout kernels) against the CPU (plain, f32, the same masks
regenerated from the same seed), twice on the card for bit-equal gradients;
at full depth ``train``, ``fit`` with
``DiffusionTrainer`` for a few accumulated optimizer steps from synthetic
batches with a validation step on the EMA weights (eval mode: no dropout) and
a checkpoint restored into a fresh state; a profile of one micro-step.  The
same four training phases then run on ``video_swin_1x8``, all at depth [1,1]
(``swin_train_rate0``, ``swin_train_grads``, ``swin_train``,
``profile_swin_train_step``): the general layer's all-gradients and dropout
kernels, the grouped core at rate 0, the einsum route under attention
dropout.  Evaluation and data (after ``graph_recapture``): ``eval_suite``,
an ensemble forecast (2 members of 2 synthetic contexts, 50 DDIM steps)
unguided and guided, each scored on the card by a ``ForecastEvalSuite``
(skill scores, MSE, MAE, SSIM, CRPS, FVD on one seeded 224x224 I3D) and
held against the same suites on the CPU; ``data_prefetch``, augmented
training batches through ``prefetch_to_device`` (pinned memory, a side
stream) bit-equal to the host's, and the diffusion trainer's validation
step fed by it and by blocking copies, bit-equal, with the step's ms both
ways.  The opt-in bf16 conv route (``use_pallas_conv=True`` in both
networks) and the round-1 cuboid ops: ``conv_kernels_vs_plain`` (the conv
forward and its input gradient at every shape of the route),
``cuboid_core_vs_plain`` and ``cuboid_layer_v3_vs_plain`` right after
``kernels_vs_plain``; after the axial forecasts ``conv_routes`` (the route's
launches per call held to the JAX routing rule's), a UNet forward and a
guidance shift card against CPU, ``conv_forecast`` and
``conv_guided_forecast`` with exact counts, profiles; after the swin
phases the forecast on bf16 parameters (``bf16params_*``, also ``--only
bf16params``: ``cast_to_bf16`` of the seeded weights): the bf16 forms of
rows 1-3 at the UNet's shapes and of the general layer, its input gradient
and the grouped core at the swin path's, a bf16 UNet forward card against
CPU, the ``CHAIN_STEPS``-step DDPM and 50-step guided DDIM chains with a bf16 carry, the
swin chains with guidance in bf16, and the bf16 tree on an f32 carry
bit-equal to the f32 pipeline on the rounded weights; after ``train``,
``conv_train_grads``, ``conv_train`` and ``profile_conv_train_step`` (no
rate-0 phase; depth [1,1]).  The programs of ``prediff_torch/cli`` last (``cli_*``, also
``--only cli``), at full width with the kernels' counts and a spy on every
plain version (``cli_sample``, ``cli_test`` and ``cli_convert`` held to
their chains' exact counts, read before the phase's own checks launch
anything): ``cli_sample`` (guided DDIM forecasts bit-equal to the
library call with the program's generators), ``cli_train`` (the UNet at
depth [1,1]: micro-steps, a validation, the JAX script's metric keys, a
resume), ``cli_test``
(``run_eval``'s keys; suites refilled from its ``.npy`` dumps agree),
``cli_vae``, ``cli_align``, ``cli_convert`` (``from_npz`` on the converted
files forecasts bit for bit as ``from_torch``); ``cli_learning_check`` ran
during the build;
without h5py, pandas or matplotlib on the host they run the functions below
each ``main`` on in-memory synthetic windows.  Then several ranks
(``mesh_*``, also ``--only mesh``; ``prediff_torch/parallel``), child
processes of this script that join their groups themselves: two gloo ranks
on the one card (``mesh_ensemble``: 8 members of one context sharded 4 a
rank, 20 DDPM steps on graphs, the draws each rank's rows of the
one-process draws bit for bit, both ranks' outputs bit-equal, near the
one-process ensemble; ``mesh_guided``: 10 guided DDIM steps, eager on gloo,
and the guidance's energy summed over the ranks; ``mesh_eval``:
``train_sevirlr_prediff --test --multihost``, the reduced metrics the merge
of the ranks' suites bit for bit), then one NCCL rank
(``mesh_nccl_graph``: the all-reduce inside a captured guided step,
bit-equal to the eager chain and to the call without a mesh).  Then DDP
training (``ddp_*``, also ``--only ddp``; the trainers' ``mesh=``), child
processes likewise: two gloo ranks, one sample a rank, ``ddp_train`` (the
recipe's UNet at its rates, 2 optimizer steps of 2 micro-steps: each rank's
local gradients bit-equal to one process's at the rank's batch with the
same draws and dropout element base, the reduced mean bit-equal to the mean
of both, the ranks bit-equal after every micro-step, exact launches, ms per
micro-step and per gradient all-reduce), ``ddp_align`` (the same for the
alignment net), ``ddp_vae`` (the VAE-GAN at 4 frames a rank against one
process at 8, each rank's own BatchNorm statistics the control that misses
the bar), then one NCCL rank (``ddp_nccl``: a micro-step with the mesh
bit-equal to one without).  The dropout kernels' cases also run at a
nonzero element base (``DROP_BASES``) against their plain versions.  The
model variants the JAX package builds from its configuration (also ``--only
variants``), after ``align_train``: ``ffn_activations`` (each FFN kernel, its
dropout forms and the bf16 forms of rows 2 and 6 on relu, leaky and silu
against their plain versions at the UNet's FFN shapes, each an entry of the
kernels line), ``variant_guided_forecast`` (a UNet on leaky with no relative
bias, "t+hw", scale-shift time blocks and init modes "1", guided by an
alignment net with hierarchical position embeddings, one FFN after all
attentions, no final projection and silu: ``VARIANT_STEPS`` guided DDPM steps,
eager and on graphs, exact launches), ``variant_globals_forecast`` (a UNet with
8 global vectors, unguided), ``variant_vs_cpu`` (depth-[1,1] copies of those
and of a relu / global-vector / pooled-readout and a gated alignment net:
forward, all gradients and the input gradient card against CPU) and
``variant_train`` (one trainer micro-step on each of the three at the
recipes' rates: the dropout kernels on leaky and silu).  After the ``ddp_*``
children ``scan_mesh`` (``train_step_scan`` on a mesh, child processes
likewise: two gloo ranks at depth [1,1] on the split graphs around the host
all-reduce, each rank bit-equal to its eager mesh micro-steps and the ranks to
each other; one NCCL rank at full depth with the all-reduce captured,
bit-equal to its eager mesh micro-steps and to the scan without a mesh).  Last
``steps_per_call`` (also ``--only scan``, with ``scan_mesh`` first):
``devseed_kernels_vs_plain`` (rows 15a-15d with the seed read from the card,
bit-equal to the int-seed forms and against their plain versions at base 0
and ``DROP_BASES``, each an entry of the kernels line), ``train_scan`` (the
recipe's trainer, K = 4 micro-steps a call replayed from captured graphs,
from pixels and from moments, bit-equal to as many eager micro-steps,
launches per replay, ms against the eager ones; ``train_scan_released``, what
the card holds once it is dropped) and ``scan_optins`` (the same under
``remat_unet`` from moments and pixels, and with bf16 moments and shadow).
Then the ``kernels`` summary line (per kernel its ms,
bound, library call and ``vs_library``; the conv, the grouped cores, the
round-1 layer, the GroupNorm+SiLU forward and all-gradients backward and the
FFN, axial attention and general cuboid layer forwards and all-gradients
backwards also their device time alone from CUDA-graph replay, the forwards
and the FFN and axial dropout backwards with
``library_seq_ms``, the sequence of library calls that computes their
function (for a backward: autograd's backward of that sequence, with the
kernels' masks)), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that line is printed.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM (dense): HBM 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, TF32 tensor cores 495, f32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
F32_FLOP_PER_S = 67e12

CHAIN_STEPS = 25        # DDPM steps of each forecast chain (of the schedule's 1000)
SEED = 0
AVG_X_GT = 0.5          # the knowledge target of the guided chains
SHIFT_TOL_REL_L2 = 5e-2  # card vs CPU guidance shift (tests/test_guidance_kernels.py bar)
SHIFT_MIN_COSINE = 0.99
TRAIN_OPT_STEPS = 3      # optimizer steps of the train phase
TRAIN_ACCUM = 2          # micro-steps per optimizer step
TRAIN_SCHEDULE_STEPS = 100   # the run whose first optimizer steps are taken: 10 of warmup
DROP_SEED, DROP_SITE, DROP_RATE = 0x5EED_0F_D20905, 7, 0.1   # the kernels_vs_plain dropout cases
GRAD_TOL_REL_L2 = 5e-2   # card vs CPU gradient over all leaves (bf16 operands vs f32)
GRAD_MIN_COSINE = 0.99
LOSS_TOL_REL = 1e-3

# name: (source, TPU kernel it replaces, the path whose run gives its launches
# and whose mix of shapes weighs its times)
KERNELS = {
    "groupnorm_silu": ("prediff_torch/csrc/groupnorm.cu", "prediff_tpu/ops/pallas_groupnorm.py:127",
                       "guided_forecast"),
    "ffn": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:126", "guided_forecast"),
    "axial_attention": ("prediff_torch/csrc/attention.cu",
                        "prediff_tpu/ops/pallas_attention.py:778", "guided_forecast"),
    "ffn_bwd_dx": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:445",
                   "guided_forecast"),
    "axial_attention_bwd_dx": ("prediff_torch/csrc/attention.cu",
                               "prediff_tpu/ops/pallas_attention.py:927", "guided_forecast"),
    "resblock": ("prediff_torch/csrc/resblock.cu", "prediff_tpu/ops/pallas_resblock.py:458",
                 "guided_forecast"),
    "resblock_bwd": ("prediff_torch/csrc/resblock.cu", "prediff_tpu/ops/pallas_resblock.py:530",
                     "guided_forecast"),
    "ffn_bwd_full": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:375",
                     "train_rate0"),
    "axial_attention_bwd_full": ("prediff_torch/csrc/attention.cu",
                                 "prediff_tpu/ops/pallas_attention.py:1311", "train_rate0"),
    "groupnorm_silu_bwd_full": ("prediff_torch/csrc/groupnorm.cu",
                                "prediff_tpu/ops/pallas_groupnorm.py:277", "train"),
    # the seed= forms of the two attention kernels: the line of their seed argument
    "ffn_dropout": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:673", "train"),
    "ffn_dropout_bwd_full": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:722",
                             "train"),
    "axial_attention_dropout": ("prediff_torch/csrc/attention.cu",
                                "prediff_tpu/ops/pallas_attention.py:792", "train"),
    "axial_attention_dropout_bwd_full": ("prediff_torch/csrc/attention.cu",
                                         "prediff_tpu/ops/pallas_attention.py:1325", "train"),
    # the non-axial cuboid patterns: the video_swin_1x8 configuration's path
    "cuboid_attention": ("prediff_torch/csrc/attention.cu",
                         "prediff_tpu/ops/pallas_attention.py:520", "swin_guided_forecast"),
    "cuboid_attention_bwd_dx": ("prediff_torch/csrc/attention.cu",
                                "prediff_tpu/ops/pallas_attention.py:862", "swin_guided_forecast"),
    "cuboid_attention_grouped": ("prediff_torch/csrc/attention.cu",
                                 "prediff_tpu/ops/pallas_attention.py:175",
                                 "swin_guided_forecast"),
    # training the non-axial patterns: the general layer's all gradients, and
    # the seed= forms of the layer and of that backward (the line of their seed argument)
    "cuboid_attention_bwd_full": ("prediff_torch/csrc/attention.cu",
                                  "prediff_tpu/ops/pallas_attention.py:1196", "swin_train_rate0"),
    "cuboid_attention_dropout": ("prediff_torch/csrc/attention.cu",
                                 "prediff_tpu/ops/pallas_attention.py:533", "swin_train"),
    "cuboid_attention_dropout_bwd_full": ("prediff_torch/csrc/attention.cu",
                                          "prediff_tpu/ops/pallas_attention.py:1209",
                                          "swin_train"),
    # the opt-in bf16 3x3x3 conv (use_pallas_conv=True): its forward, and its
    # input gradient (the same pallas_call on the flipped weights, from _diff_bwd)
    "conv3x3x3": ("prediff_torch/csrc/conv3d.cu", "prediff_tpu/ops/pallas_conv3d.py:129",
                  "conv_guided_forecast"),
    "conv3x3x3_dx": ("prediff_torch/csrc/conv3d.cu", "prediff_tpu/ops/pallas_conv3d.py:189",
                     "conv_train"),
    # the round-1 core and whole layer ("v3"): standalone ops that no model calls,
    # so on no path (launches 0)
    "cuboid_core": ("prediff_torch/csrc/attention.cu", "prediff_tpu/ops/pallas_attention.py:103",
                    None),
    "cuboid_layer_v3": ("prediff_torch/csrc/attention.cu",
                        "prediff_tpu/ops/pallas_attention.py:322", None),
}
# which path's launches per step weigh a kernel's times
PATH_WEIGHTS = {"guided_forecast": ("per_unet", "per_align"), "train": ("per_train",),
                "train_rate0": ("per_train",), "swin_guided_forecast": ("per_unet", "per_align"),
                "swin_train": ("per_train",), "swin_train_rate0": ("per_train",),
                "conv_guided_forecast": ("conv_per_unet", "conv_per_align"),
                "conv_train": ("conv_per_train",), None: ()}
SWIN_PATTERN = "video_swin_1x8"   # the pattern of the swin phases, UNet and alignment net
# patterns checked card against CPU at full width, depth [1,1]: between them
# every route and strategy (general layer at vol 256 and on dilated cuboids,
# the grouped core on padded, shifted and whole-input windows)
PATTERN_CHECKS = ("divided_st", "spatial_lg_v1", "axial_space_dilate_2", "video_swin_2x8", "full")
CUBOID_LAYER_KERNELS = ("cuboid_attention", "cuboid_attention_bwd_dx", "cuboid_attention_bwd_full",
                        "cuboid_attention_dropout", "cuboid_attention_dropout_bwd_full")
CUBOID_KERNELS = CUBOID_LAYER_KERNELS + ("cuboid_attention_grouped",)
CONV_KERNELS = ("conv3x3x3", "conv3x3x3_dx")
ROUND1_KERNELS = ("cuboid_core", "cuboid_layer_v3")
# the conv route's launches on the v1 recipe (the JAX package's routing rule):
# per UNet forward at B=1, per guidance shift, per training micro-step at B=2
# (the alignment net's training micro-step runs on the default route: no conv kernel)
CONV_EXPECTED = {"conv3x3x3": {"per_unet": 33, "per_align": 1, "per_train": 16,
                               "per_align_train": 0},
                 "conv3x3x3_dx": {"per_unet": 0, "per_align": 1, "per_train": 16,
                                  "per_align_train": 0}}
CONV_TOL_REL = 1e-3      # conv kernel vs plain: share of the output's max (same bf16 rounding)
ROUND1_TOL_REL = 1e-5    # round-1 core and layer vs plain: f32 on both sides
# each pair: the kernel without dropout, then its dropout form
FFN_FORWARDS = ("ffn", "ffn_dropout")
FFN_BACKWARDS = ("ffn_bwd_full", "ffn_dropout_bwd_full")
ATTN_FORWARDS = ("axial_attention", "axial_attention_dropout")
ATTN_BACKWARDS = ("axial_attention_bwd_full", "axial_attention_dropout_bwd_full")
CUBOID_FORWARDS = ("cuboid_attention", "cuboid_attention_dropout")
CUBOID_BACKWARDS = ("cuboid_attention_bwd_full", "cuboid_attention_dropout_bwd_full")
PAIRS = (FFN_FORWARDS, FFN_BACKWARDS, ATTN_FORWARDS, ATTN_BACKWARDS, CUBOID_FORWARDS,
         CUBOID_BACKWARDS)


LOG = []  # open files that every emitted line is also written to
GRAPH_CHAINS = {}  # phase -> the captured chain's numbers, for the graph_chains line
T0 = time.perf_counter()  # every phase line carries its seconds since the start (t_s)


def emit(obj) -> None:
    """Print ``obj`` as one JSON line (and to ``LOG``); a phase line gains ``t_s``."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T0)
    line = json.dumps(obj)
    print(line, flush=True)
    for f in LOG:
        f.write(line + "\n")
        f.flush()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_time_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed, timed with events.  No host time: what ``time_ms`` measures
    when a wrapper's own cost is below the kernel's."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


def kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled (nested) function name, with its
    integer and bool template arguments: ``_ZN..._9_conv3d_cu_...17conv_wgmma_kernelE...``
    -> ``conv_wgmma_kernel``, ``...19grouped_core_kernelILi8EE...`` ->
    ``grouped_core_kernel<8>``, ``...16ffn_wgmma_kernelILi256ELb1EE...`` ->
    ``ffn_wgmma_kernel<256, true>``."""
    import re

    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if not args:
        return name
    vals = [("true" if v == "1" else "false") if t == "b" else v
            for t, v in re.findall(r"L([ib])(\d+)E", args.group(1))]
    return f"{name}<{', '.join(vals)}>"


def ptxas_by_function(log: str) -> dict:
    """``nvcc -Xptxas -v``'s report per kernel: registers, static shared
    memory and spills (bytes) under the kernel's name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
            name += f"#{sum(k.split('#')[0] == name for k in out)}" if name in out else ""
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(m.group(1)),
                                            static_smem=int(smem.group(1)) if smem else 0)
    return out


def bound(bytes_moved: float, bf16_flops: float = 0.0, f32_flops: float = 0.0,
          tf32_flops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = (bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S
             + tf32_flops / TF32_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def errors(got, want):
    err = (got.double() - want.double()).abs()
    return float(err.max()), float(err.max() / want.double().abs().max().clamp_min(1e-30)), float(err.mean())


def rel_l2_and_cosine(got, want):
    """rel-L2 error and cosine of two lists of tensors over all their elements."""
    import torch

    g = torch.cat([t.detach().cpu().double().flatten() for t in got])
    w = torch.cat([t.detach().cpu().double().flatten() for t in want])
    return float((g - w).norm() / w.norm()), float(g @ w / (g.norm() * w.norm()))


# GN: no matmul, f32 both ways; only the sum order differs.  FFN and
# attention forwards: bf16 operands rounded at the same points on both
# sides; a flipped rounding moves a few outputs by up to ~1e-2 (absolute).
# Gradients and the resblock chain more roundings: held to a share of
# their own scale (max 3e-2, mean 2e-3 of max |plain|).
def judge(c, got, want, tol=None, rel_tol=3e-2, rel_mean_tol=2e-3):
    e = errors(got, want)
    scale = float(want.abs().max())
    if tol is not None:
        ok = e[0] <= tol
    else:
        ok = e[0] <= rel_tol * scale and e[2] <= rel_mean_tol * scale
    c.update(max_abs_err=e[0], max_rel_err=e[1], mean_abs_err=e[2], ok=ok,
             tol=tol if tol is not None else {"rel_max": rel_tol, "rel_mean": rel_mean_tol})
    return ok


def judge_all(c, names, got, want, **tols):
    """A kernel with several outputs: each held to its own scale; the case
    keeps the worst absolute error and every output's."""
    per_output = {}
    for name, gt, wt in zip(names, got, want):
        if wt is None:
            continue
        one = {}
        judge(one, gt, wt, **tols)
        per_output[name] = one
    worst = max(per_output.values(), key=lambda o: o["max_rel_err"])
    c.update(worst, ok=all(o["ok"] for o in per_output.values()),
             max_abs_err=max(o["max_abs_err"] for o in per_output.values()),
             outputs={k: {"max_abs_err": o["max_abs_err"], "max_rel_err": o["max_rel_err"]}
                      for k, o in per_output.items()})


def judge_drop(c, shapes, observed_drop, bit_equal, device):
    """The dropout cases' own checks.  The kept share of each mask the kernel
    regenerates (``keep_mask`` on the card: the kernel agrees with the plain
    version under it) and, where the output shows it, the share the kernel
    itself dropped, each within 4 sigma of its rate; and the kernel at rate 0
    with a seed against the kernel without dropout."""
    from prediff_torch.ops.dropout import keep_mask

    shares = {}
    for tensor, shape in enumerate(shapes):
        m = keep_mask(DROP_SEED, DROP_SITE, tensor, shape, DROP_RATE, device)
        shares[f"tensor{tensor}"] = (float(m.mean()), m.numel())
    if observed_drop is not None:
        shares["observed"] = (1.0 - float(observed_drop[0]), observed_drop[1])
    c["kept_share"] = {k: v[0] for k, v in shares.items()}
    c["kept_share_ok"] = all(
        abs(share - (1 - DROP_RATE)) <= 4 * (DROP_RATE * (1 - DROP_RATE) / n) ** 0.5
        for share, n in shares.values())
    c["rate0_bit_equal"] = bit_equal
    c["ok"] = c["ok"] and c["kept_share_ok"] and bit_equal


# the dropout kernels' element bases in the base checks: a rank past the first's masks
# (ops/dropout.py), multiples of 4, one past 2**32 (the Philox counter's high word)
DROP_BASES = (2 ** 32 + 4 * 1234, 4 * 5678)


def judge_base(c, kernel_at, plain_at, names=None):
    """A dropout kernel at the element bases ``DROP_BASES`` against its plain
    version at the same bases, at the base-0 case's bar (the forwards 2e-2;
    the backwards each gradient's own scale); its output must differ from the
    kernel's at base 0 (the masks moved).  ``kernel_at(bases)``,
    ``plain_at(bases)``; ``names``: a backward's outputs."""
    import torch

    got, want, at0 = kernel_at(DROP_BASES), plain_at(DROP_BASES), kernel_at((0, 0))
    one = {}
    if names is None:
        judge(one, got, want, tol=2e-2)
        moved = not torch.equal(got, at0)
    else:
        judge_all(one, names, got, want)
        moved = not all(torch.equal(a, b) for a, b in zip(got, at0))
    c["base"] = {"bases": list(DROP_BASES), "max_abs_err": one["max_abs_err"],
                 "max_rel_err": one["max_rel_err"], "masks_moved": moved,
                 "ok": bool(one["ok"] and moved)}
    c["ok"] = c["ok"] and c["base"]["ok"]


def timed(c, kernel, plain, nbytes, library=None, device_time=False, library_seq=None,
          **flops):
    """Times a case: ``ms`` per wrapper call (events around back-to-back
    calls: the host's share included where it is the larger), the plain
    version's, the bound, the library call's and ``vs_library`` = ms /
    library_ms; ``library_seq_ms``, where no single call computes the
    function, the time of the sequence of library calls that does (a
    yardstick, labelled apart from ``library_ms``, which stays None); with
    ``device_time`` also each call's device time alone (``graph_time_ms``)."""
    c.update(ms=time_ms(kernel), plain_ms=time_ms(plain), bound=bound(nbytes, **flops),
             library_ms=None if library is None else time_ms(library))
    c["vs_library"] = None if library is None else c["ms"] / c["library_ms"]
    if library_seq is not None:
        c["library_seq_ms"] = time_ms(library_seq)
    if device_time:
        c["device_ms"] = graph_time_ms(kernel)
        if library is not None:
            c["library_device_ms"] = graph_time_ms(library)
            c["vs_library_device"] = c["device_ms"] / c["library_device_ms"]
        if library_seq is not None:
            c["library_seq_device_ms"] = graph_time_ms(library_seq)


def library_act(act: str):
    """The library call of an FFN activation: ``F.gelu``, ``F.relu``,
    ``F.leaky_relu`` (0.1) or ``F.silu``."""
    import torch.nn.functional as F

    return {"gelu": F.gelu, "relu": F.relu, "silu": F.silu,
            "leaky": lambda h: F.leaky_relu(h, 0.1)}[act]


def ffn_library_seq(x, ln_w, ln_b, w1, b1, w2, b2, rate_act=0.0, rate_out=0.0, act="gelu"):
    """The FFN as a sequence of library calls on pre-cast bf16 weights:
    ``F.layer_norm`` -> ``F.linear`` -> the activation (``library_act``; ->
    ``F.dropout``) -> ``F.linear`` (-> ``F.dropout``) -> + x."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    w1b, b1b, w2b, b2b = (t.to(bf16) for t in (w1, b1, w2, b2))
    C = x.shape[-1]
    activation = library_act(act)

    def run():
        h = activation(F.linear(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5).to(bf16), w1b, b1b))
        if rate_act:
            h = F.dropout(h, rate_act)
        y = F.linear(h, w2b, b2b)
        return x + (F.dropout(y, rate_out) if rate_out else y).float()

    return run


def attention_library_seq(x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale,
                          rate_attn=0.0, rate_proj=0.0):
    """The axial layer as a sequence of library calls on pre-cast bf16
    weights: ``F.layer_norm`` -> ``F.linear`` -> SDPA on the axis's cuboids
    with the relative bias as ``attn_mask`` (and ``dropout_p``) ->
    ``F.linear`` (-> ``F.dropout``)."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    wq, bb, wp, bp = (t.to(bf16) for t in (w_qkv, bias, w_proj, b_proj))
    C = x.shape[-1]

    def run():
        qkv = F.linear(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5).to(bf16), wq).movedim(1 + axis, 3)
        lead = qkv.shape[:4]
        q, k, v = qkv.reshape(-1, lead[3], 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bb, dropout_p=rate_attn,
                                           scale=scale)
        o = o.transpose(1, 2).reshape(*lead, C).movedim(3, 1 + axis)
        y = F.linear(o, wp, bp)
        return (F.dropout(y, rate_proj) if rate_proj else y).float()

    return run


def gn_library_seq(x, w, b, emb, groups):
    """GroupNorm + emb + SiLU as library calls on the channel-last (B, N, C):
    ``F.silu(F.group_norm(x + emb[:, None]))`` through channel-first views."""
    import torch.nn.functional as F

    def run():
        xe = x if emb is None else x + emb[:, None]
        return F.silu(F.group_norm(xe.transpose(1, 2), groups, w, b, 1e-5)).transpose(1, 2)

    return run


def cuboid_library_seq(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, rate_attn=0.0,
                       rate_proj=0.0):
    """The general layer as library calls on pre-cast bf16 weights, on the
    reordered (B, cuboids, vol, C): ``F.layer_norm`` -> ``F.linear`` -> SDPA
    per cuboid with the relative bias as a float ``attn_mask`` (and
    ``dropout_p``) -> ``F.linear`` (-> ``F.dropout``)."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    wq, bb, wp, bp = (t.to(bf16) for t in (w_qkv, bias, w_proj, b_proj))
    B, nC, vol, C = x.shape

    def run():
        qkv = F.linear(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5).to(bf16), wq)
        q, k, v = qkv.reshape(B * nC, vol, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bb, dropout_p=rate_attn,
                                           scale=scale)
        y = F.linear(o.transpose(1, 2).reshape(B, nC, vol, C), wp, bp)
        return (F.dropout(y, rate_proj) if rate_proj else y).float()

    return run


def v3_library_seq(x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale):
    """The round-1 whole layer as f32 library calls on the reordered (B,
    cuboids, vol, C), the products in full f32 (TF32 off, as
    ``set_numerics`` leaves it): ``F.layer_norm`` -> ``F.linear`` -> SDPA
    per cuboid with the relative bias as a float ``attn_mask`` ->
    ``F.linear``."""
    import torch.nn.functional as F

    B, nC, vol, C = x.shape

    def run():
        qkv = F.linear(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5), w_qkv)
        q, k, v = qkv.reshape(B * nC, vol, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
        return F.linear(o.transpose(1, 2).reshape(B, nC, vol, C), w_proj, b_proj)

    return run


def ffn_library_bwd(x, g, ln_w, ln_b, w1, b1, w2, rate_act, rate_out, seed, site, act="gelu"):
    """The yardstick of the FFN's all-gradients backward with dropout:
    autograd's backward of ``ffn_library_seq``'s calls on bf16 weights with
    the kernels' masks (``keep_mask`` of ``(seed, site)``) multiplied in, all
    seven gradients.  Returns the closure that runs it."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.dropout import keep_mask

    M, C = x.shape
    bf16 = torch.bfloat16
    m1 = keep_mask(seed, site, 0, (M, w1.shape[0]), rate_act, x.device) / (1 - rate_act)
    m2 = keep_mask(seed, site, 1, (M, C), rate_out, x.device) / (1 - rate_out)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, ln_w, ln_b, w1, b1, w2, torch.zeros_like(ln_b))]
    xl, lw, lb, w1l, b1l, w2l, b2l = leaves
    h = library_act(act)(F.linear(F.layer_norm(xl, (C,), lw, lb, 1e-5).to(bf16), w1l.to(bf16),
                                  b1l.to(bf16)))
    out = xl + F.linear(h * m1.to(bf16), w2l.to(bf16), b2l.to(bf16)).float() * m2
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def attention_library_bwd(x, g, axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale, rate_attn,
                          rate_proj, seed, site):
    """The yardstick of the axial layer's all-gradients backward with
    dropout: autograd's backward of ``attention_library_seq``'s calls (LN,
    linear, the scores with the relative bias, softmax, p . v, linear) on
    bf16 weights with the kernels' two masks multiplied in (the attention
    mask in the layout's cuboid order: the same work), all seven gradients."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.dropout import keep_mask

    B, T, H, W, C = x.shape
    vol = (T, H, W)[axis]
    bf16 = torch.bfloat16
    n = B * T * H * W // vol
    m_a = keep_mask(seed, site, 0, (n, heads, vol, vol), rate_attn, x.device) / (1 - rate_attn)
    m_p = keep_mask(seed, site, 1, tuple(x.shape), rate_proj, x.device) / (1 - rate_proj)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, ln_w, ln_b, w_qkv, bias, w_proj, torch.zeros_like(ln_b))]
    xl, lw, lb, wq, bl, wp, bp = leaves
    qkv = F.linear(F.layer_norm(xl, (C,), lw, lb, 1e-5).to(bf16), wq.to(bf16)).movedim(1 + axis, 3)
    lead = qkv.shape[:4]
    q, k, v = qkv.reshape(-1, vol, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    s = (q * scale) @ k.transpose(-1, -2) + bl.to(bf16)
    p = torch.softmax(s.float(), dim=-1) * m_a
    o = (p.to(bf16) @ v).transpose(1, 2).reshape(*lead, C).movedim(3, 1 + axis)
    out = F.linear(o, wp.to(bf16), bp.to(bf16)).float() * m_p
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def cuboid_library_bwd(x, g, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale, rate_attn,
                       rate_proj, seed, site):
    """The yardstick of the general layer's all-gradients backward with
    dropout: autograd's backward of ``cuboid_library_seq``'s calls (LN,
    linear, the scores with the relative bias, softmax, p . v, linear) on
    bf16 weights with the kernels' two masks multiplied in, on the reordered
    (B, cuboids, vol, C), all seven gradients."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.dropout import keep_mask

    B, nC, vol, C = x.shape
    bf16 = torch.bfloat16
    m_a = keep_mask(seed, site, 0, (B, nC, heads, vol, vol), rate_attn, x.device) / (1 - rate_attn)
    m_p = keep_mask(seed, site, 1, tuple(x.shape), rate_proj, x.device) / (1 - rate_proj)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, ln_w, ln_b, w_qkv, bias, w_proj, torch.zeros_like(ln_b))]
    xl, lw, lb, wq, bl, wp, bp = leaves
    qkv = F.linear(F.layer_norm(xl, (C,), lw, lb, 1e-5).to(bf16), wq.to(bf16))
    q, k, v = qkv.reshape(B, nC, vol, 3, heads, C // heads).permute(3, 0, 1, 4, 2, 5)
    s = (q * scale) @ k.transpose(-1, -2) + bl.to(bf16)
    p = torch.softmax(s.float(), dim=-1) * m_a
    o = (p.to(bf16) @ v).transpose(2, 3).reshape(B, nC, vol, C)
    out = F.linear(o, wp.to(bf16), bp.to(bf16)).float() * m_p
    return lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)


def resblock_library_seq(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups):
    """The whole resblock as library calls, a yardstick (no one call does
    the block): ``F.group_norm`` -> ``F.silu`` -> the cuDNN bf16 conv
    (channels-last 3-D) -> + emb -> ``F.group_norm`` -> ``F.silu`` -> the
    cuDNN bf16 conv -> + x, on x's channel-last memory through
    channel-first views.  Returns (the forward's closure, the closure of
    autograd's backward of it for a cotangent to x and emb)."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    cl = torch.channels_last_3d
    k1b, k2b = (k.to(bf16).contiguous(memory_format=cl) for k in (k1, k2))
    b1b, b2b = b1.to(bf16), b2.to(bf16)

    def block(xl, el):
        xc = xl.permute(0, 4, 1, 2, 3)
        h = F.silu(F.group_norm(xc, groups, g1s, g1b, 1e-5)).to(bf16)
        h2 = F.conv3d(h, k1b, b1b, padding=1).float() + el[:, :, None, None, None]
        h = F.silu(F.group_norm(h2, groups, g2s, g2b, 1e-5)).to(bf16)
        return (xc + F.conv3d(h, k2b, b2b, padding=1).float()).permute(0, 2, 3, 4, 1)

    xl, el = (t.detach().clone().requires_grad_(True) for t in (x, emb))
    out = block(xl, el)
    g = torch.randn_like(out)
    return (lambda: block(x, emb),
            lambda: torch.autograd.grad(out, (xl, el), g, retain_graph=True))


def yardstick(c, fn):
    """A backward yardstick's times on the case: ``library_seq_ms`` per call
    and ``library_seq_device_ms``, its kernels' device time summed by the
    profiler (autograd's backward is not captured in a CUDA graph)."""
    c["library_seq_ms"] = time_ms(fn)
    c["library_seq_device_ms"] = launch_split(fn)[0]


# --------------------------------------------------------------------------- #
def kernel_cases(unet, align, train_batch: int, align_batch: int):
    """Every (kernel, shape) of the paths, with launches per UNet forward at
    B=1 (``per_unet``), per guidance shift, alignment forward and backward
    (``per_align``), per training micro-step at ``train_batch`` samples,
    forward and backward (``per_train``; with dropout the dropout kernels
    take the FFN's and the attention's launches), and per alignment training
    micro-step at ``align_batch`` samples and the recipe's rates
    (``per_align_train``: the GN and resblock kernels and the dropout forms)."""
    cases = {k: [] for k in KERNELS}

    def add(name, per_unet=0, per_align=0, per_train=0, per_align_train=0, **shape):
        cases[name].append(dict(shape, per_unet=per_unet, per_align=per_align,
                                per_train=per_train, per_align_train=per_align_train))

    for B, key in ((1, "per_unet"), (train_batch, "per_train")):
        # a micro-step runs each forward kernel once and, behind it, its all-gradients backward
        train = key == "per_train"
        gn = ("groupnorm_silu", "groupnorm_silu_bwd_full") if train else ("groupnorm_silu",)
        ffn = FFN_FORWARDS + FFN_BACKWARDS if train else ("ffn",)
        attn = ATTN_FORWARDS + ATTN_BACKWARDS if train else ("axial_attention",)
        T, H, W, C0 = unet.mem_shapes[0]
        fp = unet.first_proj
        for name in gn:
            add(name, shape=[B, T * H * W, unet.data_shape[-1]], groups=fp.in_groups, emb=False,
                **{key: 1})
            add(name, shape=[B, T * H * W, C0], groups=fp.out_groups, emb=False, **{key: 1})
        for i, (t, h, w, c) in enumerate(unet.mem_shapes):
            n = unet.depth[i] * 2  # down + up calls of the stage's time blocks
            groups = unet.down_time_embed_blocks[i].in_groups
            for name in gn:
                add(name, shape=[B, t * h * w, c], groups=groups, emb=False, **{key: n})
                add(name, shape=[B, t * h * w, c], groups=groups, emb=True, **{key: n})
            for name in ffn:
                add(name, shape=[B * t * h * w, c], **{key: 3 * n})
            for name in attn:
                for axis in range(3):
                    add(name, shape=[B, t, h, w, c], axis=axis, **{key: n})

    # a group past a cluster's shared memory: the two-pass route (on no path)
    add("groupnorm_silu", shape=[1, 240000, 64], groups=32, emb=True)
    T, H, W, Cin = align.input_shape
    fp = align.first_proj
    # first_proj changes width, so it keeps the GN kernel, whose backward is the all-gradients one
    for name in ("groupnorm_silu", "groupnorm_silu_bwd_full"):
        add(name, per_align=1, shape=[1, T * H * W, Cin], groups=fp.in_groups, emb=False)
        add(name, per_align=1, shape=[1, T * H * W, align.mem_shapes[0][-1]],
            groups=fp.out_groups, emb=False)
    for i, (t, h, w, c) in enumerate(align.mem_shapes):
        n = align.depth[i]
        groups = align.down_time_embed_blocks[i].in_groups
        for name in ("ffn", "ffn_bwd_dx"):
            add(name, per_align=3 * n, shape=[t * h * w, c])
        for name in ("axial_attention", "axial_attention_bwd_dx"):
            for axis in range(3):
                add(name, per_align=n, shape=[1, t, h, w, c], axis=axis)
        for name in ("resblock", "resblock_bwd"):
            add(name, per_align=n, shape=[1, t, h, w, c], groups=groups)
    # the alignment net's training micro-step: the same sites at align_batch samples
    Ba = align_batch
    for name in ("groupnorm_silu", "groupnorm_silu_bwd_full"):
        add(name, per_align_train=1, shape=[Ba, T * H * W, Cin], groups=fp.in_groups, emb=False)
        add(name, per_align_train=1, shape=[Ba, T * H * W, align.mem_shapes[0][-1]],
            groups=fp.out_groups, emb=False)
    for i, (t, h, w, c) in enumerate(align.mem_shapes):
        n = align.depth[i]
        for name in ("ffn_dropout", "ffn_dropout_bwd_full"):
            add(name, per_align_train=3 * n, shape=[Ba * t * h * w, c])
        for name in ("axial_attention_dropout", "axial_attention_dropout_bwd_full"):
            for axis in range(3):
                add(name, per_align_train=n, shape=[Ba, t, h, w, c], axis=axis)
        for name in ("resblock", "resblock_bwd"):
            add(name, per_align_train=n, shape=[Ba, t, h, w, c],
                groups=align.down_time_embed_blocks[i].in_groups)
    return cases


def check_kernels(cases, device):
    """Each case: the kernel against its plain version (bf16 operands rounded
    at the same points) on the same inputs, the error, the times and the
    bound.  Adds its results to the case dicts; returns the failed cases."""
    import torch
    from prediff_torch.ops.attention import (axial_attention_bwd_dx_plain,
                                             axial_attention_bwd_full_plain, axial_attention_plain,
                                             fused_axial_attention, fused_axial_attention_bwd_dx,
                                             fused_axial_attention_bwd_full,
                                             fused_axial_attention_dropout,
                                             fused_axial_attention_dropout_bwd_full)
    from prediff_torch.ops.ffn import (ffn_bwd_dx_plain, ffn_bwd_full_plain,
                                       ffn_dropout_bwd_full_plain, ffn_dropout_plain, ffn_plain,
                                       fused_ffn, fused_ffn_bwd_dx, fused_ffn_bwd_full,
                                       fused_ffn_dropout, fused_ffn_dropout_bwd_full)
    from prediff_torch.ops.groupnorm import (fused_groupnorm_silu, fused_groupnorm_silu_bwd_full,
                                             gn_bwd_plan, gn_plan, groupnorm_silu_bwd_full_plain,
                                             groupnorm_silu_plain)
    from prediff_torch.ops.resblock import (fused_resblock_bwd, fused_resblock_fwd,
                                            resblock_bwd_plain, resblock_plain)

    gen = torch.Generator(device=device).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    def vec(C, scale=0.1, shift=0.0):
        return randn(C, scale=scale, shift=shift)

    failed = []
    for c in cases["groupnorm_silu"]:
        B, N, C = c["shape"]
        groups = c["groups"]
        x = randn(B, N, C, scale=2.0, shift=1.0)
        w, b = vec(C, shift=1.0), vec(C)
        emb = randn(B, C) if c["emb"] else None
        got, want = fused_groupnorm_silu(x, w, b, emb, groups), groupnorm_silu_plain(x, w, b, emb, groups)
        sync(device)
        judge(c, got, want, tol=1e-4)
        c["route"] = "two_pass" if gn_plan(B, N, C, groups) is None else "cluster"
        c["bit_equal_across_two_runs"] = torch.equal(got, fused_groupnorm_silu(x, w, b, emb, groups))
        c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]
        timed(c, lambda: fused_groupnorm_silu(x, w, b, emb, groups),
              lambda: groupnorm_silu_plain(x, w, b, emb, groups),
              4 * (2 * B * N * C + 2 * C + (B * C if emb is not None else 0)),
              device_time=True, library_seq=gn_library_seq(x, w, b, emb, groups),
              f32_flops=12 * B * N * C)

    for c in cases["groupnorm_silu_bwd_full"]:
        B, N, C = c["shape"]
        groups = c["groups"]
        x, g = randn(B, N, C, scale=2.0, shift=1.0), randn(B, N, C)
        w, b = vec(C, shift=1.0), vec(C)
        emb = randn(B, C) if c["emb"] else None
        got = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups)
        want = groupnorm_silu_bwd_full_plain(x, g, w, b, emb, groups)
        sync(device)
        # all f32 on both sides, only the order of the sums differs: 1e-4 of the
        # output's scale (dgamma and dbeta sum B * N terms and reach the hundreds)
        judge_all(c, ("dx", "dgamma", "dbeta", "demb"), got, want, rel_tol=1e-4, rel_mean_tol=1e-5)
        c["route"] = "one_block" if gn_bwd_plan(B, N, C, groups) is None else "cluster"
        again = fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups)
        c["bit_equal_across_two_runs"] = all(a is b or torch.equal(a, b) for a, b in zip(got, again))
        c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]
        # the nearest library route: autograd of F.group_norm + F.silu, its backward alone
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)] + (
            [emb.clone().requires_grad_(True)] if emb is not None else [])
        xin = leaves[0] + leaves[3][:, None] if emb is not None else leaves[0]
        y = torch.nn.functional.silu(torch.nn.functional.group_norm(
            xin.transpose(1, 2), groups, leaves[1], leaves[2], 1e-5)).transpose(1, 2)
        kernel = lambda: fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups)  # noqa: E731
        library = lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)  # noqa: E731
        timed(c, kernel, lambda: groupnorm_silu_bwd_full_plain(x, g, w, b, emb, groups),
              4 * (3 * B * N * C + 4 * C + (2 * B * C if emb is not None else 0)),
              library=library, f32_flops=30 * B * N * C)
        # device time alone: the kernels' from graph replay; autograd's backward runs
        # on its forward's stream and cannot be captured on a side stream, so the
        # library's is its kernels' sum by the profiler
        c["device_ms"] = graph_time_ms(kernel)
        c["library_device_ms"] = launch_split(library)[0]
        c["vs_library_device"] = c["device_ms"] / c["library_device_ms"]

    drop = (DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
    for name, c in [(n, c) for n in ("ffn", "ffn_bwd_dx", "ffn_bwd_full", "ffn_dropout",
                                     "ffn_dropout_bwd_full") for c in cases[n]]:
        M, C = c["shape"]
        hid = 4 * C
        x, ln_w, ln_b = randn(M, C), vec(C, shift=1.0), vec(C)
        w1, b1 = randn(hid, C, scale=C ** -0.5), vec(hid)
        w2, b2 = randn(C, hid, scale=hid ** -0.5), vec(C)
        if name == "ffn_dropout":
            # the masks are bit-identical on both sides, so the tolerances without dropout hold
            args = (x, ln_w, ln_b, w1, b1, w2, b2, 1e-5)
            got = fused_ffn_dropout(*args, *drop)
            want = ffn_dropout_plain(*args, *drop, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want, tol=2e-2)
            # the residual is never masked: out == x exactly where the output mask dropped
            judge_drop(c, [(M, hid), (M, C)], (float((got == x).float().mean()), M * C),
                       torch.equal(fused_ffn_dropout(*args, 0.0, 0.0, DROP_SEED, DROP_SITE),
                                   fused_ffn(*args)), device)
            judge_base(c, lambda b: fused_ffn_dropout(*args, *drop, bases=b),
                       lambda b: ffn_dropout_plain(*args, *drop, mxu_dtype=bf16, bases=b))
            timed(c, lambda: fused_ffn_dropout(*args, *drop),
                  lambda: ffn_dropout_plain(*args, *drop, mxu_dtype=bf16),
                  4 * (2 * M * C + 2 * C * hid + hid + 3 * C), device_time=True,
                  library_seq=ffn_library_seq(*args[:7], *drop[:2]), bf16_flops=4 * M * C * hid)
        elif name == "ffn_dropout_bwd_full":
            args = (x, randn(M, C), ln_w, ln_b, w1, b1, w2, 1e-5)
            got = fused_ffn_dropout_bwd_full(*args, *drop)
            want = ffn_dropout_bwd_full_plain(*args, *drop, mxu_dtype=bf16)
            sync(device)
            judge_all(c, ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2"), got, want)
            zero = fused_ffn_dropout_bwd_full(*args, 0.0, 0.0, DROP_SEED, DROP_SITE)
            judge_drop(c, [(M, hid), (M, C)], None,
                       all(torch.equal(a, b) for a, b in zip(zero, fused_ffn_bwd_full(*args))),
                       device)
            judge_base(c, lambda b: fused_ffn_dropout_bwd_full(*args, *drop, bases=b),
                       lambda b: ffn_dropout_bwd_full_plain(*args, *drop, mxu_dtype=bf16,
                                                            bases=b),
                       ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2"))
            timed(c, lambda: fused_ffn_dropout_bwd_full(*args, *drop),
                  lambda: ffn_dropout_bwd_full_plain(*args, *drop, mxu_dtype=bf16),
                  4 * (3 * M * C + 4 * C * hid + 2 * hid + 5 * C), device_time=True,
                  bf16_flops=10 * M * C * hid)
            yardstick(c, ffn_library_bwd(*args[:7], *drop))
        elif name == "ffn_bwd_full":
            args = (x, randn(M, C), ln_w, ln_b, w1, b1, w2)
            got = fused_ffn_bwd_full(*args)
            want = ffn_bwd_full_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_all(c, ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2"), got, want)
            timed(c, lambda: fused_ffn_bwd_full(*args),
                  lambda: ffn_bwd_full_plain(*args, mxu_dtype=bf16),
                  4 * (3 * M * C + 4 * C * hid + 2 * hid + 5 * C), device_time=True,
                  bf16_flops=10 * M * C * hid)
        elif name == "ffn":
            args = (x, ln_w, ln_b, w1, b1, w2, b2)
            got, want = fused_ffn(*args), ffn_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want, tol=2e-2)
            timed(c, lambda: fused_ffn(*args), lambda: ffn_plain(*args, mxu_dtype=bf16),
                  4 * (2 * M * C + 2 * C * hid + hid + 3 * C), device_time=True,
                  library_seq=ffn_library_seq(*args), bf16_flops=4 * M * C * hid)
        else:
            args = (x, randn(M, C), ln_w, ln_b, w1, b1, w2)
            got = fused_ffn_bwd_dx(*args)
            want = ffn_bwd_dx_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want)
            timed(c, lambda: fused_ffn_bwd_dx(*args),
                  lambda: ffn_bwd_dx_plain(*args, mxu_dtype=bf16),
                  4 * (3 * M * C + 2 * C * hid + hid + 2 * C), bf16_flops=6 * M * C * hid)

    heads = 4
    for name, c in [(n, c) for n in ("axial_attention", "axial_attention_bwd_dx",
                                     "axial_attention_bwd_full", "axial_attention_dropout",
                                     "axial_attention_dropout_bwd_full") for c in cases[n]]:
        B, T, H, W, C = c["shape"]
        axis = c["axis"]
        vol = (T, H, W)[axis]
        M = B * T * H * W
        x, ln_w, ln_b = randn(B, T, H, W, C), vec(C, shift=1.0), vec(C)
        w_qkv, bias = randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5)
        w_proj, b_proj = randn(C, C, scale=C ** -0.5), vec(C)
        scale = (C // heads) ** -0.5
        mask_shapes = [(M // vol, heads, vol, vol), (B, T, H, W, C)]
        if name == "axial_attention_dropout":
            args = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, 1e-5)
            got = fused_axial_attention_dropout(*args, *drop)
            want = axial_attention_plain(*args, bf16, *drop)
            sync(device)
            judge(c, got, want, tol=2e-2)
            judge_drop(c, mask_shapes, (float((got == 0).float().mean()), M * C),
                       torch.equal(fused_axial_attention_dropout(*args, 0.0, 0.0, DROP_SEED,
                                                                 DROP_SITE),
                                   fused_axial_attention(*args)), device)
            judge_base(c, lambda b: fused_axial_attention_dropout(*args, *drop, bases=b),
                       lambda b: axial_attention_plain(*args, bf16, *drop, bases=b))
            timed(c, lambda: fused_axial_attention_dropout(*args, *drop),
                  lambda: axial_attention_plain(*args, bf16, *drop),
                  4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C), device_time=True,
                  library_seq=attention_library_seq(*args[:10], *drop[:2]),
                  bf16_flops=8 * M * C * C + 4 * M * vol * C)
        elif name == "axial_attention_dropout_bwd_full":
            args = (x, randn(B, T, H, W, C), axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale,
                    1e-5)
            got = fused_axial_attention_dropout_bwd_full(*args, *drop)
            want = axial_attention_bwd_full_plain(*args, bf16, *drop)
            sync(device)
            judge_all(c, ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj"), got,
                      want)
            zero = fused_axial_attention_dropout_bwd_full(*args, 0.0, 0.0, DROP_SEED, DROP_SITE)
            judge_drop(c, mask_shapes, None,
                       all(torch.equal(a, b)
                           for a, b in zip(zero, fused_axial_attention_bwd_full(*args))), device)
            judge_base(c, lambda b: fused_axial_attention_dropout_bwd_full(*args, *drop, bases=b),
                       lambda b: axial_attention_bwd_full_plain(*args, bf16, *drop, bases=b),
                       ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj"))
            timed(c, lambda: fused_axial_attention_dropout_bwd_full(*args, *drop),
                  lambda: axial_attention_bwd_full_plain(*args, bf16, *drop),
                  4 * (3 * M * C + 8 * C * C + 2 * heads * vol * vol + 5 * C), device_time=True,
                  bf16_flops=22 * M * C * C + 12 * M * vol * C)
            yardstick(c, attention_library_bwd(*args[:10], *drop))
        elif name == "axial_attention_bwd_full":
            args = (x, randn(B, T, H, W, C), axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale)
            got = fused_axial_attention_bwd_full(*args)
            want = axial_attention_bwd_full_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_all(c, ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj"), got, want)
            timed(c, lambda: fused_axial_attention_bwd_full(*args),
                  lambda: axial_attention_bwd_full_plain(*args, mxu_dtype=bf16),
                  4 * (3 * M * C + 8 * C * C + 2 * heads * vol * vol + 5 * C), device_time=True,
                  bf16_flops=22 * M * C * C + 12 * M * vol * C)
        elif name == "axial_attention":
            args = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)
            got = fused_axial_attention(*args)
            want = axial_attention_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want, tol=2e-2)
            timed(c, lambda: fused_axial_attention(*args),
                  lambda: axial_attention_plain(*args, mxu_dtype=bf16),
                  4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C), device_time=True,
                  library_seq=attention_library_seq(*args),
                  bf16_flops=8 * M * C * C + 4 * M * vol * C)
        else:
            args = (x, randn(B, T, H, W, C), axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale)
            got = fused_axial_attention_bwd_dx(*args)
            want = axial_attention_bwd_dx_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want)
            timed(c, lambda: fused_axial_attention_bwd_dx(*args),
                  lambda: axial_attention_bwd_dx_plain(*args, mxu_dtype=bf16),
                  4 * (3 * M * C + 4 * C * C + heads * vol * vol + 2 * C),
                  bf16_flops=14 * M * C * C + 10 * M * vol * C)

    for c_fwd, c_bwd in zip(cases["resblock"], cases["resblock_bwd"]):
        B, T, H, W, C = c_fwd["shape"]
        groups = c_fwd["groups"]
        M = B * T * H * W
        k1, k2 = (randn(C, C, 3, 3, 3, scale=(27 * C) ** -0.5) for _ in range(2))
        args = (randn(B, T, H, W, C, scale=0.5), randn(B, C, scale=0.3), k1, vec(C), k2, vec(C),
                vec(C, shift=1.0), vec(C), vec(C, shift=1.0), vec(C))
        out, h2 = fused_resblock_fwd(*args, groups)
        want_out, want_h2 = resblock_plain(*args, groups, mxu_dtype=bf16)
        sync(device)
        ok = judge(c_fwd, out, want_out)
        c_fwd["h2_max_abs_err"] = errors(h2.float(), want_h2)[0]
        c_fwd["ok"] = ok and c_fwd["h2_max_abs_err"] <= 3e-2 * float(want_h2.abs().max())
        conv_flops = 2 * 2 * M * 27 * C * C
        weights = 4 * 2 * 27 * C * C
        library_fwd, library_bwd = resblock_library_seq(*args, groups)
        timed(c_fwd, lambda: fused_resblock_fwd(*args, groups),
              lambda: resblock_plain(*args, groups, mxu_dtype=bf16),
              4 * 2 * M * C + 2 * M * C + weights + 4 * (B * C + 6 * C), device_time=True,
              library_seq=library_fwd, bf16_flops=conv_flops)
        x, emb, _, _, _, _, g1s, g1b, g2s, g2b = args
        bargs = (x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, randn(B, T, H, W, C), groups)
        dx, demb = fused_resblock_bwd(*bargs)
        want_dx, want_demb = resblock_bwd_plain(*bargs[:8], h2.float(), bargs[9], groups,
                                                mxu_dtype=bf16)
        sync(device)
        ok = judge(c_bwd, dx, want_dx)
        c_bwd["demb_max_abs_err"] = errors(demb, want_demb)[0]
        c_bwd["ok"] = ok and c_bwd["demb_max_abs_err"] <= 3e-2 * float(want_demb.abs().max())
        timed(c_bwd, lambda: fused_resblock_bwd(*bargs),
              lambda: resblock_bwd_plain(*bargs[:8], h2.float(), bargs[9], groups,
                                         mxu_dtype=bf16),
              4 * 3 * M * C + 2 * M * C + weights + 4 * (2 * B * C + 4 * C), device_time=True,
              bf16_flops=conv_flops)
        yardstick(c_bwd, library_bwd)

    for name, cs in cases.items():
        failed += [(name, c) for c in cs if not c["ok"]]
    return failed


def conv_sites(model, batch: int, grad: bool, force: bool = False):
    """The 3x3x3 convs of ``model`` (UNet or alignment net) that take the conv
    kernel at ``batch`` samples, as (kernel, [B, T, H, W, C, OC], calls per
    model call): the time-embedding blocks with the conv route on (every
    block when ``force``; never the alignment net's fused resblocks), each
    conv the JAX routing rule admits, and with ``grad`` (guidance, training)
    its input gradient where the rule admits the cotangent."""
    from prediff_torch.ops.conv3d import supports_shape

    if hasattr(model, "up_time_embed_blocks"):   # the UNet: down and up calls of each stage
        blocks = [(model.first_proj, model.data_shape, 1)] + [
            (blk, model.mem_shapes[i], model.depth[i])
            for blks in (model.down_time_embed_blocks, model.up_time_embed_blocks)
            for i, blk in enumerate(blks)]
    else:
        blocks = [(model.first_proj, model.input_shape, 1)] + [
            (blk, model.mem_shapes[i], model.depth[i])
            for i, blk in enumerate(model.down_time_embed_blocks)]
    out = []
    for blk, (t, h, w, _), n in blocks:
        if blk.fused or not (force or blk.conv_kernel):
            continue
        for conv in (blk.in_layers[2], blk.out_layers[3]):
            c, oc = conv.in_channels, conv.out_channels
            if supports_shape(t, h, w, c, oc, batch):
                out.append(("conv3x3x3", [batch, t, h, w, c, oc], n))
                if grad and supports_shape(t, h, w, oc, c, batch):
                    out.append(("conv3x3x3_dx", [batch, t, h, w, c, oc], n))
    return out


def conv_cases(unet, align, train_batch: int):
    """The conv kernels' cases: each shape of the conv route on the v1 recipe,
    its launches per UNet forward at B=1, per guidance shift and per training
    micro-step under ``conv_per_unet`` / ``conv_per_align`` /
    ``conv_per_train`` (the default route launches none: ``per_*`` are 0)."""
    cases = {k: {} for k in CONV_KERNELS}
    for model, batch, grad, key in ((unet, 1, False, "conv_per_unet"),
                                    (align, 1, True, "conv_per_align"),
                                    (unet, train_batch, True, "conv_per_train")):
        for name, shape, n in conv_sites(model, batch, grad, force=True):
            c = cases[name].setdefault(tuple(shape), dict(
                shape=shape, per_unet=0, per_align=0, per_train=0, conv_per_unet=0,
                conv_per_align=0, conv_per_train=0))
            c[key] += n
    return {k: list(v.values()) for k, v in cases.items()}


def check_conv_kernels(cases, device):
    """The conv forward and input gradient against their plain versions (x,
    g and the weights rounded to bf16 on both sides, f32 sums), held to
    ``CONV_TOL_REL`` of the output's max, with times, bounds and two library
    yardsticks: cuDNN on bf16 channels-last tensors (``library_ms``) and the
    f32 cuDNN conv the default route runs (``library_f32_ms``)."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.conv3d import (conv3x3x3_dx, conv3x3x3_dx_plain, conv3x3x3_forward,
                                          conv3x3x3_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    cl = torch.channels_last_3d
    for name in CONV_KERNELS:
        for c in cases[name]:
            B, T, H, W, C, OC = c["shape"]
            M = B * T * H * W
            w = torch.randn((OC, C, 3, 3, 3), generator=gen, device=device) * (27 * C) ** -0.5
            b = 0.1 * torch.randn((OC,), generator=gen, device=device)
            wb = w.to(torch.bfloat16).contiguous(memory_format=cl)
            if name == "conv3x3x3":
                x = torch.randn((B, T, H, W, C), generator=gen, device=device)
                kernel = lambda: conv3x3x3_forward(x, w, b)  # noqa: E731
                plain = lambda: conv3x3x3_plain(x, w, b)  # noqa: E731
                xb, bb = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3), b.to(torch.bfloat16)
                library = lambda: F.conv3d(xb, wb, bb, padding=1)  # noqa: E731
                library_f32 = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w, b,  # noqa: E731
                                               padding=1)
            else:
                g = torch.randn((B, T, H, W, OC), generator=gen, device=device)
                kernel = lambda: conv3x3x3_dx(g, w)  # noqa: E731
                plain = lambda: conv3x3x3_dx_plain(g, w)  # noqa: E731
                gb = g.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
                library = lambda: F.conv_transpose3d(gb, wb, padding=1)  # noqa: E731
                library_f32 = lambda: F.conv_transpose3d(  # noqa: E731
                    g.permute(0, 4, 1, 2, 3), w, padding=1)
            got, want = kernel(), plain()
            sync(device)
            judge(c, got, want, tol=CONV_TOL_REL * float(want.abs().max()))
            timed(c, kernel, plain, 4 * (M * C + M * OC + 27 * C * OC + OC), library=library,
                  device_time=True, bf16_flops=2 * M * 27 * C * OC)
            c["library_f32_ms"] = time_ms(library_f32)
    return [(name, c) for name in CONV_KERNELS for c in cases[name] if not c["ok"]]


# the round-1 cases: the core at video_swin_1x8's stage-0 shape with and without
# its shifted-window mask, the whole layer at the UNet's stage-0 cuboids
SWIN_STAGE0_WINDOW = [[13, 16, 16], [1, 8, 8], [0, 4, 4], ["l", "l", "l"], "zeros"]


def round1_cases():
    zero = dict(per_unet=0, per_align=0, per_train=0)
    return {"cuboid_core": [dict(zero, shape=[1, 52, 4, 64, 64], window=SWIN_STAGE0_WINDOW),
                            dict(zero, shape=[1, 52, 4, 64, 64], window=None)],
            "cuboid_layer_v3": [dict(zero, shape=[1, 52, 64, 256], heads=4)]}


def check_round1_kernels(cases, device):
    """The round-1 core and whole layer against their plain versions, f32 on
    both sides, held to ``ROUND1_TOL_REL`` of the output's max; the core's
    library yardstick is SDPA in f32 with bias and mask as one float mask (as
    row 10's), the layer has none (no one call does LN + QKV + attention +
    projection)."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.attention import (cuboid_attention_layer_v3_plain,
                                             cuboid_attention_plain_core, fused_cuboid_attention,
                                             fused_cuboid_attention_layer_v3)
    from prediff_torch.ops.cuboid import NEG_INF, compute_cuboid_self_attention_mask

    gen = torch.Generator(device=device).manual_seed(SEED + 6)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    with torch.no_grad():
        for c in cases["cuboid_core"]:
            B, nC, heads, vol, hc = c["shape"]
            q, k, v = (randn(B, nC, heads, vol, hc) for _ in range(3))
            bias = randn(heads, vol, vol, scale=0.5)
            mask = None
            if c["window"] is not None:
                dims, cs, shift, strategy, padding_type = c["window"]
                mask = torch.from_numpy(compute_cuboid_self_attention_mask(
                    tuple(dims), tuple(cs), tuple(shift), tuple(strategy), padding_type)).to(device)
            scale = hc ** -0.5
            got = fused_cuboid_attention(q, k, v, bias, mask, scale)
            want = cuboid_attention_plain_core(q, k, v, bias, mask, scale)
            sync(device)
            judge(c, got, want, tol=ROUND1_TOL_REL * float(want.abs().max()))
            add = bias[None, None] if mask is None else (
                bias[None, None] + torch.where(mask, 0.0, NEG_INF)[None, :, None])
            add = add.expand(B, nC, heads, vol, vol).reshape(B * nC * heads, 1, vol, vol)
            q4, k4, v4 = (t.reshape(B * nC * heads, 1, vol, hc) for t in (q, k, v))
            N = B * nC * heads * vol
            timed(c, lambda: fused_cuboid_attention(q, k, v, bias, mask, scale),
                  lambda: cuboid_attention_plain_core(q, k, v, bias, mask, scale),
                  4 * (4 * N * hc + heads * vol * vol) + (0 if mask is None else nC * vol * vol),
                  library=lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add,
                                                                 scale=scale),
                  device_time=True, f32_flops=4 * N * vol * hc)
            c["bound_3xtf32"] = bound(4 * (4 * N * hc + heads * vol * vol)
                                      + (0 if mask is None else nC * vol * vol),
                                      tf32_flops=12 * N * vol * hc)
        for c in cases["cuboid_layer_v3"]:
            B, nC, vol, C = c["shape"]
            heads, M = c["heads"], B * nC * vol
            args = (randn(B, nC, vol, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1),
                    randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
                    randn(C, C, scale=C ** -0.5), randn(C, scale=0.1), heads, (C // heads) ** -0.5)
            got = fused_cuboid_attention_layer_v3(*args)
            want = cuboid_attention_layer_v3_plain(*args)
            sync(device)
            judge(c, got, want, tol=ROUND1_TOL_REL * float(want.abs().max()))
            nbytes = 4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C)
            timed(c, lambda: fused_cuboid_attention_layer_v3(*args),
                  lambda: cuboid_attention_layer_v3_plain(*args), nbytes, device_time=True,
                  library_seq=v3_library_seq(*args), f32_flops=8 * M * C * C + 4 * M * vol * C)
            # the products and the core in 3xTF32: three TF32 products of each
            c["bound_3xtf32"] = bound(nbytes, tf32_flops=3 * (8 * M * C * C + 4 * M * vol * C))
    return [(name, c) for name in ROUND1_KERNELS for c in cases[name] if not c["ok"]]


def attention_layers(model, per_call: int):
    """(stage shape, layer, calls per model call) for each attention layer of
    each stage's block: a stage's blocks share one pattern, so the first block
    stands for the stage; ``per_call`` is how many block calls a stage makes
    per depth unit (2 on the UNet: down and up)."""
    out = []
    for i, shape in enumerate(model.mem_shapes):
        for layer in model.down_self_blocks[i][0].attn_l:
            out.append((tuple(shape), layer, per_call * model.depth[i]))
    return out


def swin_cases(unet, align, train_batch: int):
    """The cuboid kernels' cases on the swin paths: each route's shapes in the
    UNet (``per_unet`` launches per forward at B=1; ``per_train`` per training
    micro-step at ``train_batch`` samples, the general layer's forward and
    all-gradients kernels, with and without dropout) and the alignment net
    (``per_align`` per guidance shift, forward and backward), plus shapes no
    path of this configuration gives (weight 0): the layer's forwards at C =
    1024 (past the QKV product's LN tile), the layer kernels at vol 128
    and 256, the grouped core unmasked on video_swin_2x8's padded 2x8x8
    cuboids, with "ignore" padding (fully masked rows) and at vol 1536 (the
    "full" pattern on the alignment net)."""
    from prediff_torch.ops.cuboid import update_cuboid_size_shift_size

    cases = {k: {} for k in CUBOID_KERNELS}

    def add(name, key, n, **case):
        c = cases[name].setdefault(key, dict(case, per_unet=0, per_align=0, per_train=0))
        for k, v in n.items():
            c[k] += v

    for model, weight in ((unet, "per_unet"), (align, "per_align")):
        for (t, h, w, c), layer, n in attention_layers(model, 2 if model is unet else 1):
            route = layer.route((1, t, h, w, c))
            cs, shift = update_cuboid_size_shift_size((t, h, w), layer.cuboid_size,
                                                      layer.shift_size, layer.strategy)
            vol = cs[0] * cs[1] * cs[2]
            padded = [-(-d // b) * b for d, b in zip((t, h, w), cs)]
            nC = padded[0] * padded[1] * padded[2] // vol
            if route == "v4":
                names = ["cuboid_attention"] + (["cuboid_attention_bwd_dx"] if model is align else [])
                for name in names:
                    add(name, (nC, vol, c), {weight: n}, shape=[1, nC, vol, c])
                if model is unet:
                    for name in CUBOID_FORWARDS + CUBOID_BACKWARDS:
                        add(name, ("train", nC, vol, c), {"per_train": n},
                            shape=[train_batch, nC, vol, c])
            elif route.startswith("grouped"):
                window = ([t, h, w], list(cs), list(shift), list(layer.strategy),
                          layer.padding_type) if route == "grouped_masked" else None
                hc = c // layer.num_heads
                add("cuboid_attention_grouped", (nC, vol, hc, str(window)), {weight: n},
                    shape=[1, layer.num_heads, nC, vol, hc], window=window)
    for nC, vol, c in ((26, 128, 256), (13, 256, 256)):
        for name in CUBOID_LAYER_KERNELS:
            add(name, (nC, vol, c), {}, shape=[1, nC, vol, c])
    for name in CUBOID_FORWARDS:   # past the QKV product's LN tile: bf16 LN rows first
        add(name, (4, 64, 1024), {}, shape=[1, 4, 64, 1024])
    for shape, window in (([1, 4, 28, 128, 64], None),
                          ([1, 4, 28, 128, 64], [[13, 16, 16], [2, 8, 8], [0, 0, 0],
                                                 ["l", "l", "l"], "ignore"]),
                          ([1, 4, 1, 1536, 32], None)):
        add("cuboid_attention_grouped", (tuple(shape), str(window)), {}, shape=shape,
            window=window)
    return {k: list(v.values()) for k, v in cases.items()}


def path_launches(unet, align=None, train_batch: int = 2):
    """Launches per UNet forward at B=1, per guidance shift, per training
    micro-step and per alignment training micro-step at the recipe's rates
    (``per_align_train``: the dropout forms of the FFN and of the v4 and
    axial layers, GN in ``first_proj`` and the resblocks), every kernel, for
    any pattern: the layers' routes give the
    attention kernels (a grouped core has no backward kernel: its gradient is
    autograd of the plain version), one FFN per attention layer; GN twice in
    ``first_proj`` and in each time-block call, the alignment net's time
    blocks the resblock kernels, its ``first_proj`` GN forward and
    all-gradients backward; the conv kernel at each conv of a block with the
    conv route that the routing rule admits at the batch (``conv_sites``;
    a micro-step at ``train_batch`` samples).  ``per_train`` counts each
    forward kernel of a micro-step, its all-gradients backward, and both their
    dropout forms (``expected_train_launches`` picks the forms a run takes).
    Every layer it counts takes a kernel route (the library routes of the
    tiny configuration are ``tiny_phases``')."""
    from prediff_torch.ops.ffn import supports_shape as supports_ffn

    per = {k: {"per_unet": 0, "per_align": 0, "per_train": 0, "per_align_train": 0}
           for k in KERNELS}
    gn = 2 + 2 * 2 * sum(unet.depth)
    per["groupnorm_silu"]["per_unet"] = gn
    per["groupnorm_silu"]["per_train"] = per["groupnorm_silu_bwd_full"]["per_train"] = gn
    kernel = {"v4": "cuboid_attention", "grouped": "cuboid_attention_grouped",
              "grouped_masked": "cuboid_attention_grouped", "axial": "axial_attention"}
    models = [(unet, "per_unet")]
    if align is not None:
        for key in ("per_align", "per_align_train"):
            per["groupnorm_silu"][key] = per["groupnorm_silu_bwd_full"][key] = 2
            per["resblock"][key] = per["resblock_bwd"][key] = sum(align.depth)
        models.append((align, "per_align"))
    for model, key in models:
        for (t, h, w, c), layer, n in attention_layers(model, 2 if model is unet else 1):
            route = layer.route((1, t, h, w, c))
            if route not in kernel or not supports_ffn(t * h * w, c, 4 * c):
                fail(f"path_launches: a layer of width {c} takes the library route ({route})")
            per[kernel[route]][key] += n
            per["ffn"][key] += n
            if model is unet:
                train = [kernel[route], *FFN_FORWARDS, *FFN_BACKWARDS]
                if route in ("v4", "axial"):
                    train += [kernel[route] + s for s in ("_bwd_full", "_dropout",
                                                          "_dropout_bwd_full")]
                for name in train:
                    per[name]["per_train"] += n
            if model is align:
                per["ffn_bwd_dx"][key] += n
                for name in ("ffn_dropout", "ffn_dropout_bwd_full"):
                    per[name]["per_align_train"] += n
                if route in ("v4", "axial"):
                    per[kernel[route] + "_bwd_dx"][key] += n
                    for form in ("_dropout", "_dropout_bwd_full"):
                        per[kernel[route] + form]["per_align_train"] += n
    convs = [(unet, "per_unet", 1, False), (unet, "per_train", train_batch, True)]
    if align is not None:
        convs.append((align, "per_align", 1, True))
    for model, key, batch, grad in convs:
        for name, _, n in conv_sites(model, batch, grad):
            per[name][key] += n
    return per


def check_cuboid_kernels(cases, device):
    """The cuboid kernels against their plain versions (the layer kernels:
    bf16 operands at the same points, the dropout forms under the same masks;
    the grouped core: f32 on both sides, held to 1e-5 of the output's max),
    with times and bounds; returns the failed cases."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.attention import (cuboid_attention_bwd_dx_plain,
                                             cuboid_attention_bwd_full_plain,
                                             cuboid_attention_dropout_bwd_full_plain,
                                             cuboid_attention_dropout_plain,
                                             cuboid_attention_plain,
                                             fused_cuboid_attention_grouped,
                                             fused_cuboid_attention_layer,
                                             fused_cuboid_attention_layer_bwd_dx,
                                             fused_cuboid_attention_layer_bwd_full,
                                             fused_cuboid_attention_layer_dropout,
                                             fused_cuboid_attention_layer_dropout_bwd_full,
                                             grouped_attention_plain)
    from prediff_torch.ops.cuboid import NEG_INF, compute_cuboid_self_attention_mask

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    bf16, heads = torch.bfloat16, 4

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    drop = (DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
    grad_names = ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj")
    for name in CUBOID_LAYER_KERNELS:
        for c in cases[name]:
            B, nC, vol, C = c["shape"]
            M = B * nC * vol
            x, ln_w, ln_b = randn(B, nC, vol, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
            w_qkv, bias = randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5)
            w_proj, b_proj = randn(C, C, scale=C ** -0.5), randn(C, scale=0.1)
            scale = (C // heads) ** -0.5
            mask_shapes = [(B, nC, heads, vol, vol), (B, nC, vol, C)]
            fwd_bytes = 4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C)
            bwd_bytes = 4 * (3 * M * C + 8 * C * C + 2 * heads * vol * vol + 5 * C)
            if name == "cuboid_attention_dropout":
                args = (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, 1e-5)
                got = fused_cuboid_attention_layer_dropout(*args, *drop)
                want = cuboid_attention_dropout_plain(*args, bf16, *drop)
                sync(device)
                judge(c, got, want, tol=2e-2)
                judge_drop(c, mask_shapes, (float((got == 0).float().mean()), M * C),
                           torch.equal(fused_cuboid_attention_layer_dropout(
                               *args, 0.0, 0.0, DROP_SEED, DROP_SITE),
                               fused_cuboid_attention_layer(*args)), device)
                judge_base(c, lambda b: fused_cuboid_attention_layer_dropout(*args, *drop,
                                                                             bases=b),
                           lambda b: cuboid_attention_dropout_plain(*args, bf16, *drop, bases=b))
                c["bit_equal_across_two_runs"] = torch.equal(
                    got, fused_cuboid_attention_layer_dropout(*args, *drop))
                c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]
                timed(c, lambda: fused_cuboid_attention_layer_dropout(*args, *drop),
                      lambda: cuboid_attention_dropout_plain(*args, bf16, *drop), fwd_bytes,
                      device_time=True,
                      library_seq=cuboid_library_seq(*args[:9], *drop[:2]),
                      bf16_flops=8 * M * C * C + 4 * M * vol * C)
            elif name in CUBOID_BACKWARDS:
                args = (x, randn(B, nC, vol, C), ln_w, ln_b, w_qkv, bias, w_proj, heads, scale,
                        1e-5)
                if name == "cuboid_attention_bwd_full":
                    kernel = lambda: fused_cuboid_attention_layer_bwd_full(*args)  # noqa: E731
                    plain = lambda: cuboid_attention_bwd_full_plain(*args, bf16)  # noqa: E731
                else:
                    kernel = lambda: fused_cuboid_attention_layer_dropout_bwd_full(  # noqa: E731
                        *args, *drop)
                    plain = lambda: cuboid_attention_dropout_bwd_full_plain(  # noqa: E731
                        *args, bf16, *drop)
                got, want = kernel(), plain()
                sync(device)
                judge_all(c, grad_names, got, want)
                if name != "cuboid_attention_bwd_full":
                    zero = fused_cuboid_attention_layer_dropout_bwd_full(
                        *args, 0.0, 0.0, DROP_SEED, DROP_SITE)
                    judge_drop(c, mask_shapes, None, all(
                        torch.equal(a, b)
                        for a, b in zip(zero, fused_cuboid_attention_layer_bwd_full(*args))),
                        device)
                    judge_base(c, lambda b: fused_cuboid_attention_layer_dropout_bwd_full(
                                   *args, *drop, bases=b),
                               lambda b: cuboid_attention_dropout_bwd_full_plain(
                                   *args, bf16, *drop, bases=b), grad_names)
                c["bit_equal_across_two_runs"] = all(torch.equal(a, b)
                                                     for a, b in zip(got, kernel()))
                c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]
                timed(c, kernel, plain, bwd_bytes, device_time=True,
                      bf16_flops=22 * M * C * C + 12 * M * vol * C)
            elif name == "cuboid_attention":
                args = (x, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)
                got, want = fused_cuboid_attention_layer(*args), cuboid_attention_plain(
                    *args, mxu_dtype=bf16)
                sync(device)
                judge(c, got, want, tol=2e-2)
                c["bit_equal_across_two_runs"] = torch.equal(got, fused_cuboid_attention_layer(*args))
                c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]
                timed(c, lambda: fused_cuboid_attention_layer(*args),
                      lambda: cuboid_attention_plain(*args, mxu_dtype=bf16), fwd_bytes,
                      device_time=True, library_seq=cuboid_library_seq(*args),
                      bf16_flops=8 * M * C * C + 4 * M * vol * C)
            else:
                args = (x, randn(B, nC, vol, C), ln_w, ln_b, w_qkv, bias, w_proj, heads, scale)
                got = fused_cuboid_attention_layer_bwd_dx(*args)
                want = cuboid_attention_bwd_dx_plain(*args, mxu_dtype=bf16)
                sync(device)
                judge(c, got, want)
                timed(c, lambda: fused_cuboid_attention_layer_bwd_dx(*args),
                      lambda: cuboid_attention_bwd_dx_plain(*args, mxu_dtype=bf16),
                      4 * (3 * M * C + 4 * C * C + heads * vol * vol + 2 * C), device_time=True,
                      bf16_flops=14 * M * C * C + 10 * M * vol * C)

    for c in cases["cuboid_attention_grouped"]:
        B, h, nC, vol, hc = c["shape"]
        q, k, v = (randn(B, h, nC, vol, hc) for _ in range(3))
        bias = randn(h, vol, vol, scale=0.5)
        mask = None
        if c["window"] is not None:
            dims, cs, shift, strategy, padding_type = c["window"]
            mask = torch.from_numpy(compute_cuboid_self_attention_mask(
                tuple(dims), tuple(cs), tuple(shift), tuple(strategy), padding_type)).to(device)
            c["fully_masked_rows"] = int((~mask.any(-1)).sum())
        scale = hc ** -0.5
        got = fused_cuboid_attention_grouped(q, k, v, bias, mask, scale)
        want = grouped_attention_plain(q, k, v, bias, mask, scale)
        sync(device)
        judge(c, got, want, tol=1e-5 * float(want.abs().max()))
        if mask is not None and c["fully_masked_rows"]:
            c["ok"] = c["ok"] and bool((got[:, :, ~mask.any(-1)] == 0).all())
        # the library yardstick: SDPA in f32 with bias + mask as one float mask
        # (the same function on every row with an unmasked key), one batch
        # entry per (sample, head, cuboid)
        add = bias[:, None] if mask is None else bias[:, None] + torch.where(mask, 0.0, NEG_INF)
        add = add.expand(B, h, nC, vol, vol).reshape(B * h * nC, 1, vol, vol)
        q4, k4, v4 = (t.reshape(B * h * nC, 1, vol, hc) for t in (q, k, v))
        N = B * h * nC * vol
        timed(c, lambda: fused_cuboid_attention_grouped(q, k, v, bias, mask, scale),
              lambda: grouped_attention_plain(q, k, v, bias, mask, scale),
              4 * (4 * N * hc + h * vol * vol) + (0 if mask is None else nC * vol * vol),
              library=lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add,
                                                             scale=scale),
              device_time=True, f32_flops=4 * N * vol * hc)
        # the kernel's own bound: the same bytes, 3 TF32 passes on the tensor cores
        c["bound_3xtf32"] = bound(4 * (4 * N * hc + h * vol * vol)
                                  + (0 if mask is None else nC * vol * vol),
                                  tf32_flops=12 * N * vol * hc)
    return [(name, c) for name in CUBOID_KERNELS for c in cases[name] if not c["ok"]]


def expected_launches(cases, steps: int, guided: bool):
    return {name: steps * sum(c["per_unet"] + (c["per_align"] if guided else 0) for c in cs)
            for name, cs in cases.items()}


def expected_train_launches(per_train, micro_steps: int, val_steps: int, dropout: bool):
    """Wrapper calls of ``micro_steps`` training micro-steps and ``val_steps``
    validation steps, from each kernel's ``per_train`` (``path_launches``).
    A validation step runs in eval mode: the forward kernels without dropout,
    alone.  A micro-step with ``dropout`` (the recipe's rates, all above 0)
    runs the FFN's and the attention layers' dropout kernels, forward and
    all-gradients, and none of their forms without dropout; nor the grouped
    core, whose windows take the einsum route under attention dropout."""
    with_drop = tuple(pair[1] for pair in PAIRS)
    without = tuple(pair[0] for pair in PAIRS) + ("cuboid_attention_grouped",)
    forward = ("groupnorm_silu", "ffn", "axial_attention", "cuboid_attention",
               "cuboid_attention_grouped", "conv3x3x3")
    return {name: (micro_steps * (name not in (without if dropout else with_drop))
                   + val_steps * (name in forward)) * per
            for name, per in per_train.items()}


def summarize(cases, launches_by_path):
    """The ``kernels`` line: per kernel, the launches of its main path's run
    and its times weighted over that path's mix of shapes: one guided step
    (launches per UNet forward plus per guidance shift), or one training
    micro-step for the training kernels (at the recipe's dropout rates; the
    all-gradients kernels without dropout: one micro-step of ``train_rate0``;
    the conv kernels: one guided step, one micro-step of ``conv_train``).  The
    round-1 kernels are on no path: launches 0, their cases weighed alike."""
    out = []
    table = {**KERNELS, **BF16_KERNELS, **ACT_KERNELS, **SCAN_KERNELS}
    for name, cs in cases.items():
        source, replaces, main_path = table[name]
        keys = PATH_WEIGHTS[main_path]
        wts = [sum(c[k] for k in keys) for c in cs]
        if not any(wts):   # no shape of the kernel on its path at this configuration
            wts = [1] * len(cs)
        n = sum(wts)

        def mix(key, cs=cs, wts=wts, n=n):
            return sum(c[key] * w for c, w in zip(cs, wts) if w) / n

        bytes_share = sum(w for c, w in zip(cs, wts) if c["bound"][1] == "bytes") / n
        has_library = all(c["library_ms"] is not None for c in cs)
        extra = {k: mix(k) for k in ("library_f32_ms", "device_ms", "library_device_ms",
                                     "library_seq_ms", "library_seq_device_ms",
                                     "int_seed_device_ms") if k in cs[0]}
        if "library_device_ms" in extra:
            extra["vs_library_device"] = extra["device_ms"] / extra["library_device_ms"]
        if has_library:
            extra["vs_library"] = mix("ms") / mix("library_ms")
        if "bound_3xtf32" in cs[0]:
            extra["bound_3xtf32_ms"] = sum(c["bound_3xtf32"][0] * w for c, w in zip(cs, wts)) / n
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches_by_path[main_path][name] if main_path else 0,
            max_abs_err=max(c["max_abs_err"] for c in cs), ms=mix("ms"), plain_ms=mix("plain_ms"),
            bound_ms=sum(c["bound"][0] * w for c, w in zip(cs, wts)) / n,
            bound_by="bytes" if bytes_share >= 0.5 else "operations",
            library_ms=mix("library_ms") if has_library else None, main_path=main_path,
            launches_by_path={p: v[name] for p, v in launches_by_path.items() if name in v},
            launches_per_step_mix=n, **extra,
            shapes=[{k: v for k, v in c.items() if k not in ("bound", "bound_3xtf32")}
                    | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                    | ({"bound_3xtf32_ms": c["bound_3xtf32"][0]} if "bound_3xtf32" in c else {})
                    for c in cs]))
    return out


def forward_vs_cpu(phase, unet_cpu, predictor, cfg, rs, device):
    """A denoise forward at full width: the card (kernels) against the CPU
    (plain versions, f32); returns its inputs (x, t, cond)."""
    import torch

    d = cfg.model.diffusion
    x = torch.randn((1,) + tuple(d.latent_shape), generator=rs)
    cond = torch.randn((1,) + tuple(d.latent_cond_shape), generator=rs)
    t = torch.tensor([500])
    with torch.no_grad():
        t1 = time.perf_counter()
        ref = unet_cpu(x, t, cond)
        cpu_s = time.perf_counter() - t1
        got = predictor.ld.unet(x.to(device), t.to(device), cond.to(device)).cpu()
    rel_l2 = float((got - ref).norm() / ref.norm())
    max_abs = float((got - ref).abs().max())
    fwd_tol = 2e-2  # bf16 matmul operands on the card vs f32 on the CPU
    emit({"phase": phase, "shape": list(got.shape), "rel_l2_err": rel_l2,
          "max_abs_err": max_abs, "ref_max_abs": float(ref.abs().max()), "tol_rel_l2": fwd_tol,
          "cpu_forward_s": cpu_s})
    if not torch.isfinite(got).all() or rel_l2 > fwd_tol:
        fail(f"{phase}: card forward differs from the CPU forward: rel_l2 {rel_l2}")
    return x, t, cond


def shift_vs_cpu(phase, align_cpu, predictor, cfg, rs, t, want_counts, device, zero_counts,
                 read_counts):
    """The guidance shift at full width: the card (kernels, their autograd
    Functions) against the CPU (plain versions, f32), with its launch counts.
    A kernel invisible to autograd would leave only the residual paths and
    fail this.  Returns the knowledge target it used."""
    import torch
    from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment

    avg = torch.tensor([[AVG_X_GT]])
    z = torch.randn((1,) + tuple(cfg.model.align.model_args.input_shape), generator=rs)
    ka_cpu = KnowledgeAlignment(align_cpu, guide_scale=cfg.model.align.guide_scale)
    t1 = time.perf_counter()
    shift_cpu = ka_cpu.get_mean_shift(z, t, avg)
    cpu_s = time.perf_counter() - t1
    predictor.ld.alignment.get_mean_shift(z.to(device), t.to(device), avg.to(device))
    sync(device)
    zero_counts()
    t1 = time.perf_counter()
    shift_card = predictor.ld.alignment.get_mean_shift(z.to(device), t.to(device),
                                                       avg.to(device))
    sync(device)
    card_ms = 1e3 * (time.perf_counter() - t1)
    shift_card = shift_card.cpu()
    shift_counts = read_counts()
    rel_l2 = float((shift_card - shift_cpu).norm() / shift_cpu.norm())
    cosine = float((shift_card * shift_cpu).sum() / (shift_card.norm() * shift_cpu.norm()))
    emit({"phase": phase, "shape": list(shift_card.shape), "rel_l2_err": rel_l2,
          "cosine": cosine, "tol_rel_l2": SHIFT_TOL_REL_L2, "min_cosine": SHIFT_MIN_COSINE,
          "cpu_max_abs": float(shift_cpu.abs().max()), "cpu_shift_s": cpu_s,
          "card_shift_ms": card_ms, "launches": shift_counts, "expected_launches": want_counts})
    if not torch.isfinite(shift_card).all() or rel_l2 > SHIFT_TOL_REL_L2 or cosine < SHIFT_MIN_COSINE:
        fail(f"{phase}: card guidance shift differs from the CPU's: rel_l2 {rel_l2}, "
             f"cosine {cosine}")
    if shift_counts != want_counts:
        fail(f"{phase}: launches {shift_counts} != expected {want_counts}")
    return avg


def replay_ms(graph, reps: int = 20) -> float:
    """Device ms per replay of a captured step, ``reps`` replays back to back
    timed with events: the step's device time with the host out of the way."""
    import torch

    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def run_chains(predictor, context, chains, expect_shape, expected_fn, device, smi, zero_counts,
               read_counts):
    """Each chain ``phase: (predict kwargs, steps, guided)`` through
    ``predictor.predict`` twice from one seed, eager (``_plain_chain``) and
    on graphs, eager first on even chains and graph first on odd ones; each
    run with the launch counts set to 0 just before it and read just after,
    held to ``expected_fn(steps, guided)``, and the two bit-equal.  The graph
    run captures on the way: the first step of each kind runs eagerly and is
    captured, every later one replays.  Each run's step loop
    (``LatentDiffusion._chain``) is timed on its own, synchronized on both
    sides, so ``ms_per_step`` leaves out the context encode and the decode
    (``outside_steps_ms``: what the forecast spends around the loop) and the
    graph run's capture seconds.  Per chain also: captures, the pool's bytes,
    launches per replay, device ms of a step by replay (``replay_ms``) and
    each run's busy share against it.  The first chain is the unguided one
    the guidance share is taken against.  Returns the launches by phase (the
    graph run's)."""
    import contextlib

    import torch

    ld = predictor.ld
    launches_by_path, ms_per_step = {}, {}
    loop_s = []
    chain = ld._chain

    def timed_chain(*args):
        sync(device)
        t1 = time.perf_counter()
        ends = chain(*args)
        sync(device)
        loop_s.append(time.perf_counter() - t1)
        return ends

    ld._chain = timed_chain
    try:
        for n, (phase, (kw, steps, guided)) in enumerate(chains.items()):
            before = ld.graphs.entries()
            captures, capture_s = ld.graphs.captures, ld.graphs.capture_seconds
            runs = {}
            for run in (("eager", "graph") if n % 2 == 0 else ("graph", "eager")):
                sync(device)
                torch.cuda.reset_peak_memory_stats(device)
                zero_counts()
                t1 = time.perf_counter()
                with ld._plain_chain() if run == "eager" else contextlib.nullcontext():
                    out = predictor.predict(
                        context, generator=torch.Generator(device).manual_seed(SEED), **kw)
                sync(device)
                wall_s = time.perf_counter() - t1
                runs[run] = dict(wall_s=wall_s, loop_s=loop_s[-1], launches=read_counts(),
                                 out=out, peak=torch.cuda.max_memory_allocated(device) / 2**30)
            cap_s = ld.graphs.capture_seconds - capture_s
            entry = next(e for e in ld.graphs.entries() if e not in before)
            plan = entry.plan
            step_ms = {kind: replay_ms(graph) for kind, (graph, _) in entry.graphs.items()}
            device_ms = sum(step_ms[bool(g)] for g in plan.guided) / steps
            expected = expected_fn(steps, guided)
            out = runs["graph"]["out"]
            graph_ms = 1e3 * (runs["graph"]["loop_s"] - cap_s) / steps
            eager_ms = 1e3 * runs["eager"]["loop_s"] / steps
            bit_equal = torch.equal(runs["eager"]["out"], out)
            launches_by_path[phase] = runs["graph"]["launches"]
            ms_per_step[phase] = graph_ms
            line = {"phase": phase, "steps": steps, "order": list(runs),
                    "shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
                    "ms_per_step": graph_ms, "steps_per_s": 1e3 / graph_ms,
                    "eager_ms_per_step": eager_ms, "device_ms_per_step": device_ms,
                    "device_ms_per_replay": {
                        "guided" if k else "unguided": v for k, v in step_ms.items()},
                    "busy_share": device_ms / graph_ms, "eager_busy_share": device_ms / eager_ms,
                    "wall_s": runs["graph"]["wall_s"], "eager_wall_s": runs["eager"]["wall_s"],
                    "outside_steps_ms": 1e3 * (runs["graph"]["wall_s"] - runs["graph"]["loop_s"]),
                    "eager_outside_steps_ms": 1e3 * (runs["eager"]["wall_s"]
                                                     - runs["eager"]["loop_s"]),
                    "captures": ld.graphs.captures - captures, "capture_s": cap_s,
                    "pool_bytes": ld.graphs.pool_bytes(), "bit_equal_graph_eager": bit_equal,
                    "launches_per_replay": {"guided" if k else "unguided": v
                                            for k, v in entry.launches_per_replay().items()},
                    "launches": runs["graph"]["launches"], "expected_launches": expected,
                    "launches_equal_by_run": all(r["launches"] == expected
                                                 for r in runs.values()),
                    "card": smi, "peak_mem_gib": runs["graph"]["peak"]}
            if guided:
                unguided = next(iter(ms_per_step.values()))
                line["guidance_share_of_step"] = 1.0 - unguided / ms_per_step[phase]
            emit(line)
            GRAPH_CHAINS[phase] = {k: line[k] for k in (
                "order", "ms_per_step", "eager_ms_per_step", "device_ms_per_step", "busy_share",
                "eager_busy_share", "outside_steps_ms", "eager_outside_steps_ms", "captures",
                "capture_s", "pool_bytes", "bit_equal_graph_eager", "launches_equal_by_run")}
            if tuple(out.shape) != expect_shape or not torch.isfinite(out).all():
                fail(f"{phase}: shape {tuple(out.shape)} (want {expect_shape}) "
                     "or non-finite values")
            for run, r in runs.items():
                if r["launches"] != expected:
                    fail(f"{phase} ({run} run): kernel launches {r['launches']} "
                         f"!= expected {expected}")
            if not bit_equal:
                fail(f"{phase}: the graph chain differs from the eager chain at the same seed")
    finally:
        del ld._chain
    return launches_by_path


def graph_recapture(predictor, context, avg_x_gt, device):
    """A second forecast of the same key replays the graphs it captured (no
    capture, the same result); then an in-place update of one FFN weight
    (bf16 layout cached per version) before a third: that one must capture
    anew and equal the eager chain on the new weights, and differ from the
    first.  The weight is put back after."""
    import torch

    ld = predictor.ld
    kw = dict(timesteps=10, use_alignment=True, avg_x_gt=avg_x_gt)

    def forecast():
        return predictor.predict(context, generator=torch.Generator(device).manual_seed(SEED),
                                 **kw)

    name, w = next((n, p) for n, p in ld.unet.named_parameters()
                   if "ffn" in n and p.ndim == 2)
    first = forecast()
    captures = ld.graphs.captures
    reused = torch.equal(forecast(), first) and ld.graphs.captures == captures
    saved = w.detach().clone()
    with torch.no_grad():
        w.mul_(1.5)
    second = forecast()
    recaptured = ld.graphs.captures - captures
    with ld._plain_chain():
        eager = forecast()
    with torch.no_grad():
        w.copy_(saved)
    ok = (reused and recaptured == 1 and torch.equal(second, eager)
          and not torch.equal(first, second))
    emit({"phase": "graph_recapture", "updated": name, "reused_without_capture": reused,
          "recaptured": recaptured,
          "equal_to_eager": bool(torch.equal(second, eager)),
          "moved_max_abs": float((second - first).abs().max()), "ok": ok})
    if not ok:
        fail("graph_recapture: a repeated forecast captured or differed, an updated weight "
             "did not capture anew, or the new chain differs from the eager one")


def guided_step(ld, z, zc, avg_x_gt):
    """One guided DDPM step at t = T/2, temperature 1, as a chain runs it:
    its plan, buffers and noise made here once, the call runs the step alone
    (on the buffers, in place, under ``no_grad`` as in ``sample``)."""
    import torch

    plan = ld._chain_plan("ddpm", ld.num_timesteps, None, 0.0, False, 1.0, True, 1, False, 1)
    bufs = ld._buffers(plan, z, zc, None, avg_x_gt, None, None)
    bufs.t.fill_(ld.num_timesteps // 2)
    ld._draw(bufs.noise, None)

    def step():
        with torch.no_grad():
            ld._reverse_step(bufs, plan, True)

    return step


def profile(name: str, fn, reps: int):
    """Device time by kernel over ``reps`` calls of ``fn`` (torch.profiler),
    and the device's busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3 / reps, e.count / reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"phase": name, "reps": reps, "wall_ms_per_call": wall_ms / reps,
            "device_ms_per_call": busy, "device_busy_share": busy * reps / wall_ms,
            "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]} for r in rows[:25]]}


def launch_split(fn, reps: int = 10):
    """Each launch of one call of ``fn``: device ms per call by kernel
    (torch.profiler), its share of their sum, and the sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            rows.append(((e.self_cuda_time_total if us is None else us) / 1e3 / reps,
                         e.count / reps, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return total, [{"kernel": k[:80], "ms": ms, "calls": n, "share": ms / total}
                   for ms, n, k in rows]


# rows 12 / 15b and 13 / 15d at the training micro-batch (B=2) of the v1 recipe
BWD_SPLIT_FFN = ((6656, 256), (1664, 512))
BWD_SPLIT_ATTN = ((2, 13, 16, 16, 256), (2, 13, 8, 8, 512))
# rows 13b / 15e's backward at video_swin_1x8's training shapes (B, cuboids, vol, C),
# row 5 (its dx) at the swin guided chain's UNet and alignment-net shapes
BWD_SPLIT_CUBOID = ((2, 52, 64, 256), (2, 13, 64, 512))
BWD_SPLIT_CUBOID_DX = ((1, 52, 64, 256), (1, 13, 64, 512), (1, 24, 64, 128), (1, 6, 64, 256))
# row 7 at the alignment net's stage blocks
BWD_SPLIT_RESBLOCK = ((1, 6, 16, 16, 128), (1, 6, 8, 8, 256))
# row 14 at the training micro-step's GN sites (B, N, C, groups)
BWD_SPLIT_GN = ((2, 3328, 256, 32), (2, 832, 512, 32), (2, 3328, 65, 65))


def bwd_split(device):
    """The all-gradients backwards of the FFN, the axial layer, the general
    layer and GroupNorm+SiLU (rows 12, 15b, 13, 15d, 13b, 15e, 14) at the B=2
    training shapes, the general layer's dx (row 5) at the swin guided
    chain's and the whole resblock (row 7, forward and backward) at the
    alignment net's:
    each launch's share of one call's device time (profiler), the call's
    device time from CUDA-graph replay, and for the dropout forms the
    yardstick: autograd's backward of the library sequence
    (``ffn_library_seq`` / ``attention_library_seq`` / ``cuboid_library_seq``
    on bf16 weights) with the kernels' masks multiplied in, its device time
    by the profiler's sum; for row 14 autograd's backward of
    ``F.silu(F.group_norm(x + emb))``."""
    import torch
    from prediff_torch.ops.attention import (fused_axial_attention_bwd_full,
                                             fused_axial_attention_dropout_bwd_full,
                                             fused_cuboid_attention_layer_bwd_dx,
                                             fused_cuboid_attention_layer_bwd_full,
                                             fused_cuboid_attention_layer_dropout_bwd_full)
    from prediff_torch.ops.ffn import fused_ffn_bwd_full, fused_ffn_dropout_bwd_full
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu_bwd_full
    from prediff_torch.ops.resblock import fused_resblock_bwd, fused_resblock_fwd

    gen = torch.Generator(device=device).manual_seed(SEED)
    heads = 4

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    def one(kernel, shape, fn, yard=None):
        total, split = launch_split(fn)
        line = {"phase": "bwd_split", "kernel": kernel, "shape": list(shape),
                "device_ms_profiler": total, "device_ms": graph_time_ms(fn),
                "ms": time_ms(fn), "launches": split}
        if yard is not None:
            line["library_bwd_device_ms"] = launch_split(yard)[0]
            line["library_bwd_ms"] = time_ms(yard)
        emit(line)

    drop = (DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
    for M, C in BWD_SPLIT_FFN:
        hid = 4 * C
        args = (randn(M, C), randn(M, C), 1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                randn(hid, C, scale=C ** -0.5), randn(hid, scale=0.1),
                randn(C, hid, scale=hid ** -0.5), 1e-5)
        one("ffn_bwd_full", (M, C), lambda: fused_ffn_bwd_full(*args))
        one("ffn_dropout_bwd_full", (M, C), lambda: fused_ffn_dropout_bwd_full(*args, *drop),
            ffn_library_bwd(*args[:7], *drop))
    for shape in BWD_SPLIT_ATTN:
        C = shape[-1]
        for axis in range(3):
            vol = shape[1 + axis]
            args = (randn(*shape), randn(*shape), axis, 1.0 + randn(C, scale=0.1),
                    randn(C, scale=0.1), randn(3 * C, C, scale=C ** -0.5),
                    randn(heads, vol, vol, scale=0.5), randn(C, C, scale=C ** -0.5), heads,
                    (C // heads) ** -0.5, 1e-5)
            one("axial_attention_bwd_full", shape + (axis,),
                lambda: fused_axial_attention_bwd_full(*args))
            one("axial_attention_dropout_bwd_full", shape + (axis,),
                lambda: fused_axial_attention_dropout_bwd_full(*args, *drop),
                attention_library_bwd(*args[:10], *drop))
    for shape in BWD_SPLIT_CUBOID:
        B, nC, vol, C = shape
        args = (randn(*shape), randn(*shape), 1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
                randn(C, C, scale=C ** -0.5), heads, (C // heads) ** -0.5, 1e-5)
        one("cuboid_attention_bwd_full", shape, lambda: fused_cuboid_attention_layer_bwd_full(*args))
        one("cuboid_attention_dropout_bwd_full", shape,
            lambda: fused_cuboid_attention_layer_dropout_bwd_full(*args, *drop),
            cuboid_library_bwd(*args[:9], *drop))
    for shape in BWD_SPLIT_CUBOID_DX:
        B, nC, vol, C = shape
        args = (randn(*shape), randn(*shape), 1.0 + randn(C, scale=0.1), randn(C, scale=0.1),
                randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
                randn(C, C, scale=C ** -0.5), heads, (C // heads) ** -0.5, 1e-5)
        one("cuboid_attention_bwd_dx", shape, lambda: fused_cuboid_attention_layer_bwd_dx(*args))
    for shape in BWD_SPLIT_RESBLOCK:
        B, T, H, W, C = shape
        args = (randn(*shape, scale=0.5), randn(B, C, scale=0.3),
                randn(C, C, 3, 3, 3, scale=(27 * C) ** -0.5), randn(C, scale=0.1),
                randn(C, C, 3, 3, 3, scale=(27 * C) ** -0.5), randn(C, scale=0.1),
                1.0 + randn(C, scale=0.1), randn(C, scale=0.1), 1.0 + randn(C, scale=0.1),
                randn(C, scale=0.1))
        _, h2 = fused_resblock_fwd(*args)
        x, emb, k1, _, k2, _, g1s, g1b, g2s, g2b = args
        bargs = (x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, randn(*shape))
        one("resblock", shape, lambda: fused_resblock_fwd(*args))
        one("resblock_bwd", shape, lambda: fused_resblock_bwd(*bargs))
    for B, N, C, groups in BWD_SPLIT_GN:
        x, g = randn(B, N, C, scale=2.0) + 1.0, randn(B, N, C)
        w, b, emb = 1.0 + randn(C, scale=0.1), randn(C, scale=0.1), randn(B, C)
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b, emb)]
        y = torch.nn.functional.silu(torch.nn.functional.group_norm(
            (leaves[0] + leaves[3][:, None]).transpose(1, 2), groups, leaves[1], leaves[2],
            1e-5)).transpose(1, 2)
        one("groupnorm_silu_bwd_full", (B, N, C, groups),
            lambda: fused_groupnorm_silu_bwd_full(x, g, w, b, emb, groups),
            lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))


# --------------------------------------------------------------------------- #
# --------------------------------------------------------------------------- #
# compute_dtype="bfloat16" and its kin (guidance's align.compute_dtype, the
# encoder's first_stage_dtype, the VAE trainer's vae_compute_dtype): the bf16
# forms of the kernels guidance runs on the alignment net's bf16 copy, the
# bf16 chains, the bf16 encode and the bf16 VAE-GAN step.
# The kernels with a bf16 form; ``<name>_bf16`` in the kernels line.  They run
# where guidance's dtype differs from the carry's (the JAX package's rule):
# on the bf16_guidance_forecast path (chain f32, guidance bf16), per shift.
BF16_FORMS = ("groupnorm_silu", "groupnorm_silu_bwd_full", "ffn", "ffn_bwd_dx", "axial_attention",
              "axial_attention_bwd_dx", "resblock", "resblock_bwd", "conv3x3x3", "conv3x3x3_dx")
BF16_KERNELS = {f"{k}_bf16": KERNELS[k][:2] + ("conv_bf16_guidance_forecast"
                                               if k.startswith("conv") else
                                               "bf16_guidance_forecast",)
                for k in BF16_FORMS}
# The bf16 forms of the general cuboid layer, its input gradient and the
# grouped core (rows 9, 5, 10): a forecast on bf16 parameters (cast_to_bf16)
# runs them on the swin path, the UNet with a bf16 carry and the alignment
# net with guidance in bf16 (bf16params_swin_forecast, guided).
BF16_CUBOID_FORMS = ("cuboid_attention", "cuboid_attention_bwd_dx", "cuboid_attention_grouped")
BF16_KERNELS.update({f"{k}_bf16": KERNELS[k][:2] + ("bf16params_swin_guided_forecast",)
                     for k in BF16_CUBOID_FORMS})
PATH_WEIGHTS.update({"bf16_guidance_forecast": ("per_align",),
                     "conv_bf16_guidance_forecast": ("conv_per_align",),
                     "bf16params_swin_guided_forecast": ("per_unet", "per_align")})
BF16PARAMS_FORWARD_TOL = 2e-2     # the f32 forward phase's bar, card against CPU
BF16PARAMS_DDIM_STEPS = 50        # the guided DDIM chain on bf16 parameters
BF16PARAMS_F32_CARRY_STEPS = 20   # bf16params_f32_carry's DDPM and DDIM chains
BF16_CHAIN_STEPS = 2            # the bf16 guided chain held card against CPU (temperature 0)
BF16_CHAIN_TOL_REL_L2 = 2e-2
VAE_BF16_LOSS_TOL_REL = 1e-2    # card vs CPU, bf16 convolutions on both sides
VAE_BF16_GRAD_TOL_REL_L2 = 5e-2  # the adaptive weight and the total it scales
VAE_BF16_GRAD_MIN_COSINE = 0.99
# A bf16 step's gradients lie ~1e-1 (rel-L2) from the f32 step's (the
# backward rounds every activation gradient): the card's bf16 gradients are
# held to the f32 gradients (CPU) at this share of the CPU bf16 step's own
# distance to them, plus 1e-2
VAE_BF16_GRAD_DRIFT_SHARE = 1.5
PHASE_NUMBERS = {}   # phase -> numbers a later phase reports beside its own


def bf16_counts():
    """The bf16 forms' launches since the counts were last set to 0."""
    return {k + "_bf16": fn.bf16_launches for k, fn in COUNTERS.items()
            if hasattr(fn, "bf16_launches")}


def bf16_ulp(t) -> float:
    """One bf16 ulp of the largest magnitude of ``t``."""
    import math

    m = float(t.float().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def judge_bf16(c, got, want, tol=None, rel_tol=3e-2, rel_mean_tol=2e-3):
    """``judge`` of a bf16 form against its plain version on the same bf16
    inputs: the f32 form's bar plus one bf16 ulp of the output's max (both
    round their f32 result to bf16 once; the roundings may fall apart)."""
    import torch

    u, s = bf16_ulp(want), float(want.float().abs().max())
    ok = judge(c, got.float(), want.float(), tol=None if tol is None else tol + u,
               rel_tol=rel_tol + u / s, rel_mean_tol=rel_mean_tol + u / s)
    c["bf16_ulp_of_max"] = u
    c["bf16_output"] = got.dtype == torch.bfloat16
    c["ok"] = ok and c["bf16_output"]
    return c["ok"]


def bf16_kernel_cases(cases):
    """The bf16 forms' cases: each shape the alignment net gives the kernel
    in a guidance shift (``per_align``; the conv route's ``conv_per_align``),
    taken from the f32 forms' cases."""
    keep = ("shape", "groups", "emb", "axis")
    out = {}
    for name in BF16_FORMS:
        key = "conv_per_align" if name.startswith("conv") else "per_align"
        out[name + "_bf16"] = [
            {k: v for k, v in c.items() if k in keep}
            | {k: 0 for k in ("per_unet", "per_align", "per_train", "per_align_train",
                              "conv_per_unet", "conv_per_align", "conv_per_train")}
            | {key: c[key]} for c in cases[name] if c.get(key, 0)]
    return out


def resblock_library_seq_bf16(x, emb, k1, b1, k2, b2, g1s, g1b, g2s, g2b, groups):
    """The whole resblock as library calls in bf16 (the bf16 form's
    yardstick): ``F.group_norm`` -> ``F.silu`` -> cuDNN's bf16 conv -> + emb
    -> ``F.group_norm`` -> ``F.silu`` -> the conv -> + x, every tensor bf16.
    Returns (the forward's closure, the closure of autograd's backward of
    it for a cotangent to x and emb)."""
    import torch
    import torch.nn.functional as F

    cl = torch.channels_last_3d
    k1c, k2c = (k.contiguous(memory_format=cl) for k in (k1, k2))

    def block(xl, el):
        xc = xl.permute(0, 4, 1, 2, 3)
        h = F.silu(F.group_norm(xc, groups, g1s, g1b, 1e-5))
        h2 = F.conv3d(h, k1c, b1, padding=1) + el[:, :, None, None, None]
        h = F.silu(F.group_norm(h2, groups, g2s, g2b, 1e-5))
        return (xc + F.conv3d(h, k2c, b2, padding=1)).permute(0, 2, 3, 4, 1)

    xl, el = (t.detach().clone().requires_grad_(True) for t in (x, emb))
    out = block(xl, el)
    g = torch.randn_like(out)
    return (lambda: block(x, emb),
            lambda: torch.autograd.grad(out, (xl, el), g, retain_graph=True))


def check_bf16_kernels(bcases, device):
    """Each bf16 form against its plain version on the same bf16 inputs and
    bf16 parameters (the alignment net's bf16 copy; the plain version widens
    them to f32 and rounds its result to bf16), with the bar of the f32 form
    plus one bf16 ulp of the output's max; times, device times by replay, the
    bound at 2-byte activations and weights (the f32 copies of the parameter
    vectors at 4), and the bf16 library sequence's device time."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.attention import (axial_attention_bwd_dx_plain, axial_attention_plain,
                                             fused_axial_attention, fused_axial_attention_bwd_dx)
    from prediff_torch.ops.conv3d import (conv3x3x3_dx, conv3x3x3_dx_plain, conv3x3x3_forward,
                                          conv3x3x3_plain)
    from prediff_torch.ops.ffn import ffn_bwd_dx_plain, ffn_plain, fused_ffn, fused_ffn_bwd_dx
    from prediff_torch.ops.groupnorm import (fused_groupnorm_silu, fused_groupnorm_silu_bwd_full,
                                             groupnorm_silu_bwd_full_plain, groupnorm_silu_plain)
    from prediff_torch.ops.resblock import (fused_resblock_bwd, fused_resblock_fwd,
                                            resblock_bwd_plain, resblock_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(bf16)

    def vec(C, scale=0.1, shift=0.0):
        return randn(C, scale=scale, shift=shift)

    for c in bcases["groupnorm_silu_bf16"]:
        B, N, C = c["shape"]
        groups = c["groups"]
        x, w, b = randn(B, N, C, scale=2.0, shift=1.0), vec(C, shift=1.0), vec(C)
        emb = randn(B, C, scale=0.3) if c.get("emb") else None
        got, want = fused_groupnorm_silu(x, w, b, emb, groups), groupnorm_silu_plain(x, w, b,
                                                                                     emb, groups)
        sync(device)
        judge_bf16(c, got, want, tol=1e-4)
        timed(c, lambda: fused_groupnorm_silu(x, w, b, emb, groups),
              lambda: groupnorm_silu_plain(x, w, b, emb, groups),
              2 * 2 * B * N * C + 4 * 2 * C + (0 if emb is None else 2 * B * C),
              device_time=True, library_seq=gn_library_seq(x, w, b, emb, groups),
              f32_flops=12 * B * N * C)

    for c in bcases["groupnorm_silu_bwd_full_bf16"]:
        B, N, C = c["shape"]
        groups = c["groups"]
        x, g = randn(B, N, C, scale=2.0, shift=1.0), randn(B, N, C)
        w, b = vec(C, shift=1.0), vec(C)
        got = fused_groupnorm_silu_bwd_full(x, g, w, b, None, groups)
        want = groupnorm_silu_bwd_full_plain(x, g, w, b, None, groups)
        sync(device)
        judge_bf16(c, got[0], want[0], rel_tol=1e-4, rel_mean_tol=1e-5)
        side = {}
        judge_all(side, ("dgamma", "dbeta"), got[1:3], want[1:3], rel_tol=1e-4,
                  rel_mean_tol=1e-5)
        c["vector_grads"] = side["outputs"]
        c["ok"] = c["ok"] and side["ok"]
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = F.silu(F.group_norm(leaves[0].transpose(1, 2), groups, leaves[1], leaves[2],
                                1e-5)).transpose(1, 2)
        kernel = lambda: fused_groupnorm_silu_bwd_full(x, g, w, b, None, groups)  # noqa: E731
        timed(c, kernel, lambda: groupnorm_silu_bwd_full_plain(x, g, w, b, None, groups),
              2 * 3 * B * N * C + 4 * 4 * C, device_time=True, f32_flops=30 * B * N * C)
        yardstick(c, lambda: torch.autograd.grad(y, leaves, g, retain_graph=True))

    for name, c in [(n, c) for n in ("ffn_bf16", "ffn_bwd_dx_bf16") for c in bcases[n]]:
        M, C = c["shape"]
        hid = 4 * C
        x, ln_w, ln_b = randn(M, C), vec(C, shift=1.0), vec(C)
        w1, b1 = randn(hid, C, scale=C ** -0.5), vec(hid)
        w2, b2 = randn(C, hid, scale=hid ** -0.5), vec(C)
        if name == "ffn_bf16":
            args = (x, ln_w, ln_b, w1, b1, w2, b2)
            got, want = fused_ffn(*args), ffn_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_bf16(c, got, want, tol=2e-2)
            timed(c, lambda: fused_ffn(*args), lambda: ffn_plain(*args, mxu_dtype=bf16),
                  2 * (2 * M * C + 2 * C * hid) + 4 * (hid + 3 * C), device_time=True,
                  library_seq=ffn_library_seq(*args), bf16_flops=4 * M * C * hid)
        else:
            args = (x, randn(M, C), ln_w, ln_b, w1, b1, w2)
            got, want = fused_ffn_bwd_dx(*args), ffn_bwd_dx_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_bf16(c, got, want)
            timed(c, lambda: fused_ffn_bwd_dx(*args),
                  lambda: ffn_bwd_dx_plain(*args, mxu_dtype=bf16),
                  2 * (3 * M * C + 2 * C * hid) + 4 * (hid + 2 * C), device_time=True,
                  bf16_flops=6 * M * C * hid)

    heads = 4
    for name, c in [(n, c) for n in ("axial_attention_bf16", "axial_attention_bwd_dx_bf16")
                    for c in bcases[n]]:
        B, T, H, W, C = c["shape"]
        axis = c["axis"]
        vol = (T, H, W)[axis]
        M = B * T * H * W
        x, ln_w, ln_b = randn(B, T, H, W, C), vec(C, shift=1.0), vec(C)
        w_qkv, w_proj, b_proj = randn(3 * C, C, scale=C ** -0.5), randn(C, C, scale=C ** -0.5), vec(C)
        bias = randn(heads, vol, vol, scale=0.5).float()   # the layer gathers it in f32
        scale = (C // heads) ** -0.5
        if name == "axial_attention_bf16":
            args = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)
            got, want = fused_axial_attention(*args), axial_attention_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_bf16(c, got, want, tol=2e-2)
            timed(c, lambda: fused_axial_attention(*args),
                  lambda: axial_attention_plain(*args, mxu_dtype=bf16),
                  2 * (2 * M * C + 4 * C * C) + 4 * (heads * vol * vol + 3 * C), device_time=True,
                  library_seq=attention_library_seq(*args),
                  bf16_flops=8 * M * C * C + 4 * M * vol * C)
        else:
            args = (x, randn(B, T, H, W, C), axis, ln_w, ln_b, w_qkv, bias, w_proj, heads, scale)
            got = fused_axial_attention_bwd_dx(*args)
            want = axial_attention_bwd_dx_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge_bf16(c, got, want)
            timed(c, lambda: fused_axial_attention_bwd_dx(*args),
                  lambda: axial_attention_bwd_dx_plain(*args, mxu_dtype=bf16),
                  2 * (3 * M * C + 4 * C * C) + 4 * (heads * vol * vol + 2 * C), device_time=True,
                  bf16_flops=14 * M * C * C + 10 * M * vol * C)

    for c_fwd, c_bwd in zip(bcases["resblock_bf16"], bcases["resblock_bwd_bf16"]):
        B, T, H, W, C = c_fwd["shape"]
        groups = c_fwd["groups"]
        M = B * T * H * W
        k1, k2 = (randn(C, C, 3, 3, 3, scale=(27 * C) ** -0.5) for _ in range(2))
        args = (randn(B, T, H, W, C, scale=0.5), randn(B, C, scale=0.3), k1, vec(C), k2, vec(C),
                vec(C, shift=1.0), vec(C), vec(C, shift=1.0), vec(C))
        out, h2 = fused_resblock_fwd(*args, groups)
        want_out, want_h2 = resblock_plain(*args, groups, mxu_dtype=bf16)
        sync(device)
        ok = judge_bf16(c_fwd, out, want_out)
        c_fwd["h2_max_abs_err"] = errors(h2.float(), want_h2)[0]
        c_fwd["ok"] = ok and c_fwd["h2_max_abs_err"] <= (3e-2 * float(want_h2.abs().max())
                                                         + bf16_ulp(want_h2))
        conv_flops = 2 * 2 * M * 27 * C * C
        weights = 2 * 2 * 27 * C * C
        library_fwd, library_bwd = resblock_library_seq_bf16(*args, groups)
        timed(c_fwd, lambda: fused_resblock_fwd(*args, groups),
              lambda: resblock_plain(*args, groups, mxu_dtype=bf16),
              2 * 2 * M * C + 2 * M * C + weights + 2 * B * C + 4 * 6 * C, device_time=True,
              library_seq=library_fwd, bf16_flops=conv_flops)
        x, emb, _, _, _, _, g1s, g1b, g2s, g2b = args
        bargs = (x, emb, k1, k2, g1s, g1b, g2s, g2b, h2, randn(B, T, H, W, C), groups)
        dx, demb = fused_resblock_bwd(*bargs)
        want_dx, want_demb = resblock_bwd_plain(*bargs[:8], h2.float(), bargs[9], groups,
                                                mxu_dtype=bf16)
        sync(device)
        ok = judge_bf16(c_bwd, dx, want_dx)
        c_bwd["demb_max_abs_err"] = errors(demb, want_demb)[0]
        c_bwd["ok"] = ok and c_bwd["demb_max_abs_err"] <= 3e-2 * float(want_demb.abs().max())
        timed(c_bwd, lambda: fused_resblock_bwd(*bargs),
              lambda: resblock_bwd_plain(*bargs[:8], h2.float(), bargs[9], groups,
                                         mxu_dtype=bf16),
              2 * 3 * M * C + 2 * M * C + weights + 2 * B * C + 4 * (B * C + 4 * C),
              device_time=True, bf16_flops=conv_flops)
        yardstick(c_bwd, library_bwd)

    cl = torch.channels_last_3d
    for name in ("conv3x3x3_bf16", "conv3x3x3_dx_bf16"):
        for c in bcases[name]:
            B, T, H, W, C, OC = c["shape"]
            M = B * T * H * W
            w = randn(OC, C, 3, 3, 3, scale=(27 * C) ** -0.5)
            b = vec(OC)
            wc = w.contiguous(memory_format=cl)
            if name == "conv3x3x3_bf16":
                x = randn(B, T, H, W, C)
                kernel = lambda: conv3x3x3_forward(x, w, b)  # noqa: E731
                plain = lambda: conv3x3x3_plain(x, w, b)  # noqa: E731
                library = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), wc, b,  # noqa: E731
                                           padding=1)
            else:
                g = randn(B, T, H, W, OC)
                kernel = lambda: conv3x3x3_dx(g, w)  # noqa: E731
                plain = lambda: conv3x3x3_dx_plain(g, w)  # noqa: E731
                library = lambda: F.conv_transpose3d(g.permute(0, 4, 1, 2, 3), wc,  # noqa: E731
                                                     padding=1)
            got, want = kernel(), plain()
            sync(device)
            judge_bf16(c, got, want, tol=CONV_TOL_REL * float(want.float().abs().max()))
            timed(c, kernel, plain, 2 * (M * C + M * OC + 27 * C * OC) + 4 * OC, library=library,
                  device_time=True, bf16_flops=2 * M * 27 * C * OC)
    return [(name, c) for name, cs in bcases.items() for c in cs if not c["ok"]]


def shift_bf16_vs_cpu(phase, align_cpu, predictor, cfg, rs, t, device, want):
    """One guidance shift at full width with guidance in bf16 on an f32 z
    (the net on its bf16 copy: the kernels' bf16 forms), the card against the
    CPU (the plain versions on the same bf16 copy), and its launches."""
    import torch
    from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment

    avg = torch.tensor([[AVG_X_GT]])
    z = torch.randn((1,) + tuple(cfg.model.align.model_args.input_shape), generator=rs)
    ka_cpu = KnowledgeAlignment(align_cpu, guide_scale=cfg.model.align.guide_scale,
                                compute_dtype="bfloat16")
    shift_cpu = ka_cpu.get_mean_shift(z, t, avg)
    ka = predictor.ld.alignment
    ka.get_mean_shift(z.to(device), t.to(device), avg.to(device))
    sync(device)
    counters_zero()
    shift_card = ka.get_mean_shift(z.to(device), t.to(device), avg.to(device))
    sync(device)
    counts = {**counters_read(), **bf16_counts()}
    err = rel_l2_and_cosine([shift_card], [shift_cpu])
    emit({"phase": phase, "guidance_dtype": ka.compute_dtype, "z_dtype": str(z.dtype),
          "shift_dtype": str(shift_card.dtype), "rel_l2_err": err[0], "cosine": err[1],
          "tol_rel_l2": SHIFT_TOL_REL_L2, "min_cosine": SHIFT_MIN_COSINE, "launches": counts,
          "expected_launches": want})
    if (not torch.isfinite(shift_card).all() or err[0] > SHIFT_TOL_REL_L2
            or err[1] < SHIFT_MIN_COSINE or shift_card.dtype != z.dtype):
        fail(f"{phase}: the card's bf16 shift differs from the CPU's: {err}, "
             f"dtype {shift_card.dtype}")
    if counts != want:
        fail(f"{phase}: launches {counts} != expected {want}")


def bf16_phases(device, cfg, smi, weights, cases, per, align_cpu):
    """The bf16 forms against their plain versions at the alignment net's
    guidance shapes; one bf16 shift card against CPU; the chains of a
    predictor built with ``compute_dtype="bfloat16"`` and
    ``align.compute_dtype: bfloat16`` (``bf16_forecast``: the carry in bf16,
    unguided; ``bf16_guided_forecast``: carry and guidance in bf16, so the
    net keeps its f32 parameters, the JAX package's rule) and of the same
    pipeline with an f32 carry (``bf16_guidance_forecast``: the net on its
    bf16 copy, every guidance launch a bf16 form), each eager and on graphs,
    bit-equal, with exact counts (the f32 chains' and the bf16 forms'); the
    latent output's dtype; a 5-step bf16 guided chain at temperature 0 card
    against CPU; ``bf16_first_stage``: the 7-frame conditioning encode and
    a 26-frame training encode with ``first_stage_dtype: bfloat16`` against
    f32.  Returns the bf16 cases and the chains' launches."""
    import copy

    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_pipeline
    from prediff_torch.serving import PreDiffPredictor

    bcases = bf16_kernel_cases(cases)
    bad = check_bf16_kernels(bcases, device)
    emit({"phase": "bf16_kernels_vs_plain", "cases": sum(len(v) for v in bcases.values()),
          "failed": len(bad), "card": smi,
          "worst_rel_err": {k: max(c["max_rel_err"] for c in cs) for k, cs in bcases.items()}})
    if bad:
        fail(f"bf16 form disagrees with its plain version: {bad}")

    bcfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"align": {
        "compute_dtype": "bfloat16"}}}))
    pred16 = PreDiffPredictor(bcfg, params=weights, with_alignment=True, device=device,
                              compute_dtype="bfloat16")
    guidance16 = copy.copy(pred16)   # the same pipeline, the carry in f32
    guidance16.compute_dtype = "float32"
    rs = torch.Generator().manual_seed(SEED + 16)
    t = torch.tensor([cfg.model.diffusion.timesteps // 2])
    zero_forms = {k: 0 for k in BF16_KERNELS}
    shift_want = {**{k: sum(c["per_align"] for c in cs) for k, cs in cases.items()},
                  **zero_forms, **{k + "_bf16": per[k]["per_align"] for k in BF16_FORMS}}
    shift_bf16_vs_cpu("bf16_guided_shift", align_cpu, pred16, cfg, rs, t, device, shift_want)

    img = cfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    avg_x_gt = torch.tensor([[AVG_X_GT]]).numpy()

    def expected(forms):
        def fn(steps, guided):
            out = {**expected_launches(cases, steps, guided), **zero_forms}
            if forms and guided:
                out.update({k + "_bf16": steps * per[k]["per_align"] for k in BF16_FORMS})
            return out
        return fn

    def read_all():
        return {**counters_read(), **bf16_counts()}

    launches = run_chains(pred16, context, {
        "bf16_forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "bf16_guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                      avg_x_gt=avg_x_gt), CHAIN_STEPS, True)},
        expect_shape, expected(False), device, smi, counters_zero, read_all)
    launches.update(run_chains(guidance16, context, {
        "bf16_guidance_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                        avg_x_gt=avg_x_gt), CHAIN_STEPS, True)},
        expect_shape, expected(True), device, smi, counters_zero, read_all))
    emit({"phase": "bf16_chains", "card": smi, "ms_per_step": {
        k: GRAPH_CHAINS[k]["ms_per_step"] for k in ("forecast", "guided_forecast",
                                                    "bf16_forecast", "bf16_guided_forecast",
                                                    "bf16_guidance_forecast")
        if k in GRAPH_CHAINS}, "device_ms_per_step": {
        k: GRAPH_CHAINS[k]["device_ms_per_step"] for k in (
            "forecast", "guided_forecast", "bf16_forecast", "bf16_guided_forecast",
            "bf16_guidance_forecast") if k in GRAPH_CHAINS}})

    # a short bf16 guided chain (carry and guidance in bf16) at temperature 0,
    # latent output: the card against the CPU's plain versions, the same x_T
    x_T = torch.randn((1,) + tuple(cfg.model.diffusion.latent_shape), generator=rs)
    kw = dict(timesteps=BF16_CHAIN_STEPS, use_alignment=True,
              alignment_kwargs={"avg_x_gt": torch.tensor([[AVG_X_GT]])}, x_T=x_T,
              temperature=0.0, return_decoded=False, compute_dtype="bfloat16")
    card = pred16.ld.sample(context.to(device), **kw)
    ld_cpu = build_pipeline(bcfg, with_alignment=True, device="cpu", params=weights)
    t1 = time.perf_counter()
    cpu = ld_cpu.sample(context, **kw)
    cpu_s = time.perf_counter() - t1
    del ld_cpu
    err = rel_l2_and_cosine([card.float()], [cpu.float()])
    emit({"phase": "bf16_chain_vs_cpu", "steps": BF16_CHAIN_STEPS, "card_dtype": str(card.dtype),
          "cpu_dtype": str(cpu.dtype), "rel_l2_err": err[0], "cosine": err[1],
          "tol_rel_l2": BF16_CHAIN_TOL_REL_L2, "cpu_s": cpu_s})
    if card.dtype != torch.bfloat16 or cpu.dtype != torch.bfloat16 or err[0] > BF16_CHAIN_TOL_REL_L2:
        fail(f"bf16_chain_vs_cpu: latent {card.dtype} / {cpu.dtype}, rel-L2 {err[0]}")

    # first_stage_dtype: bfloat16 against f32, the conditioning encode and a training encode
    fcfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"diffusion": {
        "first_stage_dtype": "bfloat16"}}}))
    ld16 = build_pipeline(fcfg, with_alignment=False, device=device,
                          params={k: weights[k] for k in ("unet", "vae")})
    ld32 = pred16.ld
    line = {"phase": "bf16_first_stage", "card": smi}
    for label, n in (("context", img.in_len), ("training", 2 * (img.in_len + img.out_len))):
        frames = torch.rand((n, img.img_height, img.img_width, img.data_channels),
                            generator=rs).to(device)
        m16, m32 = ld16.first_stage_moments(frames), ld32.first_stage_moments(frames)
        err = rel_l2_and_cosine([m16], [m32])
        line[label] = {"frames": n, "dtype": str(m16.dtype), "rel_l2_vs_f32": err[0],
                       "ms": time_ms(lambda: ld16.first_stage_moments(frames), warmup=1, iters=5),
                       "f32_ms": time_ms(lambda: ld32.first_stage_moments(frames), warmup=1,
                                         iters=5)}
        if m16.dtype != torch.float32 or not torch.isfinite(m16).all() or err[0] > 5e-2:
            fail(f"bf16_first_stage ({label}): moments {m16.dtype}, rel-L2 {err[0]} against f32")
    emit(line)
    del ld16, pred16, guidance16
    return bcases, launches


def conv_bf16_guidance_chain(predictor, context, per, avg, expect_shape, device, smi):
    """``conv_bf16_guidance_forecast``: the conv route's ``CHAIN_STEPS``-step guided
    chain (f32 carry) with guidance in bf16, as ``align.compute_dtype:
    bfloat16`` builds it: the net on its bf16 copy, so the conv's bf16 form
    (row 8) and the other bf16 forms run on a path; eager and on graphs,
    bit-equal, exact counts.  The pipeline's f32 guidance is put back after."""
    from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment

    ld = predictor.ld
    f32_alignment = ld.alignment
    ld.alignment = KnowledgeAlignment(f32_alignment.model, guide_scale=f32_alignment.guide_scale,
                                      compute_dtype="bfloat16")

    def expected(steps, guided):
        out = {k: steps * (v["per_unet"] + (v["per_align"] if guided else 0))
               for k, v in per.items()}
        out.update({k: 0 for k in BF16_KERNELS})
        out.update({k + "_bf16": steps * per[k]["per_align"] for k in BF16_FORMS})
        return out

    try:
        return run_chains(predictor, context, {"conv_bf16_guidance_forecast": (
            dict(timesteps=CHAIN_STEPS, use_alignment=True, avg_x_gt=avg.numpy()), CHAIN_STEPS,
            True)}, expect_shape, expected, device, smi, counters_zero,
            lambda: {**counters_read(), **bf16_counts()})
    finally:
        ld.alignment = f32_alignment


def bf16_alone(device, smi):
    """``--only bf16``: the seeded full-width models as ``run`` makes them,
    the f32 ``forecast`` and ``guided_forecast`` (the numbers the bf16 chains
    are read beside), ``bf16_phases``, the conv route's f32 and bf16-guidance
    chains, and the bf16 forms' ``kernels`` line."""
    import torch
    from prediff_torch.config import alignment_default_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    cfg = prediff_default_config()
    kernel_counters()
    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    align_cpu = init_params_(build_alignment_model(cfg), gen,
                             randomize=True).eval().requires_grad_(False)
    weights = {"unet": unet_cpu.state_dict(), "vae": vae_cpu.state_dict(),
               "align": align_cpu.state_dict()}
    cases = kernel_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size,
                         alignment_default_config().optim.micro_batch_size)
    cases.update(conv_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size))
    cases.update(round1_cases())
    by_route = path_launches(unet_cpu, align_cpu)
    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device)
    img = cfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=torch.Generator().manual_seed(SEED + 1))
    run_chains(predictor, context, {
        "forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                 avg_x_gt=torch.tensor([[AVG_X_GT]]).numpy()), CHAIN_STEPS,
                            True)},
        (1, img.out_len, img.img_height, img.img_width, img.data_channels),
        lambda steps, guided: expected_launches(cases, steps, guided), device, smi,
        counters_zero, counters_read)
    del predictor
    bcases, launches = bf16_phases(device, cfg, smi, weights, cases, by_route, align_cpu)
    conv_launches, _ = conv_serving_phases(device, cfg, smi, weights, counters_zero,
                                           counters_read)
    launches.update(conv_launches)
    emit({"kernels": summarize(bcases, launches)})


# --------------------------------------------------------------------------- #
# Forecasts on bf16 parameters (utils.precision.cast_to_bf16): the UNet, the
# VAE and the alignment net on bf16 weights, each run as flax promotes it.
def bf16params_kernel_cases(cases, swin):
    """The cases of ``bf16params_kernels_vs_plain``: the bf16 forms of rows
    1-3 at the UNet's shapes (the f32 forms' ``per_unet`` cases), and those of
    rows 9, 5 and 10 at the swin path's shapes (``swin_cases``: launches per
    UNet forward or per guidance shift)."""
    keep = ("shape", "groups", "emb", "axis", "window")
    zero = {k: 0 for k in ("per_unet", "per_align", "per_train", "per_align_train",
                           "conv_per_unet", "conv_per_align", "conv_per_train")}

    def pick(c):
        return ({k: v for k, v in c.items() if k in keep} | zero
                | {k: c[k] for k in ("per_unet", "per_align")})

    out = {name + "_bf16": [pick(c) for c in cases[name] if c.get("per_unet", 0)]
           for name in ("groupnorm_silu", "ffn", "axial_attention")}
    out.update({name + "_bf16": [pick(c) for c in swin[name] if c["per_unet"] or c["per_align"]]
                for name in BF16_CUBOID_FORMS})
    return out


def check_bf16_cuboid_kernels(pcases, device):
    """The bf16 forms of the general layer, its input gradient and the grouped
    core against their plain versions on the same bf16 inputs and parameters
    (which widen them and round the output once), at the f32 forms' bars plus
    one bf16 ulp of the output's max; times, device times by replay beside
    the f32 form's on the widened inputs, the bound at 2-byte activations and
    weights, and the bf16 library sequence (the layer: LN -> linear -> SDPA ->
    linear; the core: SDPA in bf16 with bias and mask as one bf16 mask).  The
    grouped core's bf16 form is the f32 form's sums on the widened inputs: its
    output is the f32 kernel's rounded, bit for bit."""
    import torch
    import torch.nn.functional as F
    from prediff_torch.ops.attention import (cuboid_attention_bwd_dx_plain,
                                             cuboid_attention_plain,
                                             fused_cuboid_attention_grouped,
                                             fused_cuboid_attention_layer,
                                             fused_cuboid_attention_layer_bwd_dx,
                                             grouped_attention_plain)
    from prediff_torch.ops.cuboid import NEG_INF, compute_cuboid_self_attention_mask

    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    bf16, heads = torch.bfloat16, 4

    def randn(*shape, scale=1.0, shift=0.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=device) * scale + shift).to(dtype)

    for name in ("cuboid_attention_bf16", "cuboid_attention_bwd_dx_bf16"):
        for c in pcases[name]:
            B, nC, vol, C = c["shape"]
            M = B * nC * vol
            x, ln_w, ln_b = randn(B, nC, vol, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
            w_qkv, w_proj = randn(3 * C, C, scale=C ** -0.5), randn(C, C, scale=C ** -0.5)
            bias = randn(heads, vol, vol, scale=0.5, dtype=torch.float32)   # gathered in f32
            b_proj, scale = randn(C, scale=0.1), (C // heads) ** -0.5
            vecs = 4 * (heads * vol * vol + 3 * C)
            if name == "cuboid_attention_bf16":
                args = (ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)
                kernel = lambda: fused_cuboid_attention_layer(x, *args)  # noqa: E731
                plain = lambda: cuboid_attention_plain(x, *args, mxu_dtype=bf16)  # noqa: E731
                f32_form = lambda: fused_cuboid_attention_layer(x.float(), *args)  # noqa: E731
                got, want = kernel(), plain()
                sync(device)
                judge_bf16(c, got, want, tol=2e-2)
                timed(c, kernel, plain, 2 * (2 * M * C + 4 * C * C) + vecs, device_time=True,
                      library_seq=cuboid_library_seq(x, *args),
                      bf16_flops=8 * M * C * C + 4 * M * vol * C)
            else:
                g = randn(B, nC, vol, C)
                args = (ln_w, ln_b, w_qkv, bias, w_proj, heads, scale)
                kernel = lambda: fused_cuboid_attention_layer_bwd_dx(x, g, *args)  # noqa: E731
                plain = lambda: cuboid_attention_bwd_dx_plain(x, g, *args,  # noqa: E731
                                                              mxu_dtype=bf16)
                f32_form = lambda: fused_cuboid_attention_layer_bwd_dx(  # noqa: E731
                    x.float(), g.float(), *args)
                got, want = kernel(), plain()
                sync(device)
                judge_bf16(c, got, want)
                timed(c, kernel, plain, 2 * (3 * M * C + 4 * C * C) + vecs - 4 * C,
                      device_time=True, bf16_flops=14 * M * C * C + 10 * M * vol * C)
            c["bit_equal_across_two_runs"] = torch.equal(got, kernel())
            c["f32_form_device_ms"] = graph_time_ms(f32_form)
            c["ok"] = c["ok"] and c["bit_equal_across_two_runs"]

    for c in pcases["cuboid_attention_grouped_bf16"]:
        B, h, nC, vol, hc = c["shape"]
        q, k, v = (randn(B, h, nC, vol, hc) for _ in range(3))
        bias = randn(h, vol, vol, scale=0.5, dtype=torch.float32)
        mask = None
        if c["window"] is not None:
            dims, cs, shift, strategy, padding_type = c["window"]
            mask = torch.from_numpy(compute_cuboid_self_attention_mask(
                tuple(dims), tuple(cs), tuple(shift), tuple(strategy), padding_type)).to(device)
        scale = hc ** -0.5
        kernel = lambda: fused_cuboid_attention_grouped(q, k, v, bias, mask, scale)  # noqa: E731
        plain = lambda: grouped_attention_plain(q, k, v, bias, mask, scale)  # noqa: E731
        qf, kf, vf = q.float(), k.float(), v.float()
        f32_form = lambda: fused_cuboid_attention_grouped(qf, kf, vf, bias, mask,  # noqa: E731
                                                          scale)
        got, want = kernel(), plain()
        sync(device)
        judge_bf16(c, got, want, tol=1e-5 * float(want.float().abs().max()))
        c["equals_f32_form_rounded"] = torch.equal(got, f32_form().to(bf16))
        c["ok"] = c["ok"] and c["equals_f32_form_rounded"]
        add = bias[:, None] if mask is None else bias[:, None] + torch.where(mask, 0.0, NEG_INF)
        add = add.expand(B, h, nC, vol, vol).reshape(B * h * nC, 1, vol, vol).to(bf16)
        q4, k4, v4 = (t.reshape(B * h * nC, 1, vol, hc) for t in (q, k, v))
        N = B * h * nC * vol
        io = 2 * 4 * N * hc + 4 * h * vol * vol + (0 if mask is None else nC * vol * vol)
        timed(c, kernel, plain, io,
              library=lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=add,
                                                             scale=scale),
              device_time=True, bf16_flops=4 * N * vol * hc)
        c["f32_form_device_ms"] = graph_time_ms(f32_form)
        # the kernel's own bound: the same bytes, two TF32 passes a product
        c["bound_2xtf32_ms"] = bound(io, tf32_flops=8 * N * vol * hc)[0]
    return [(name, c) for name in pcases if name[:-5] in BF16_CUBOID_FORMS
            for c in pcases[name] if not c["ok"]]


def warm_shift(predictor, d, device):
    """One guidance shift on a bf16 carry before a predictor's first chains:
    the first use of a path's library calls (cuDNN's algorithms, the weight
    layouts, the promoted copies) then falls outside the chains' timed loops,
    whichever run (eager or graph) goes first."""
    import torch

    z = torch.randn((1,) + tuple(d.latent_shape), device=device).to(torch.bfloat16)
    predictor.ld.alignment.get_mean_shift(z, torch.tensor([d.timesteps // 2], device=device),
                                          torch.tensor([[AVG_X_GT]], device=device))
    sync(device)


def bf16params_phases(device, cfg, smi, weights, cases, per):
    """A forecast on bf16 parameters (``cast_to_bf16`` of the seeded weights
    ``run`` makes), at full width.  ``bf16params_kernels_vs_plain``: the
    bf16 forms of rows 1-3 at the UNet's shapes and of rows 9, 5 and 10 at
    the swin path's (``check_bf16_kernels``, ``check_bf16_cuboid_kernels``);
    ``bf16params_forward``: one UNet forward on a bf16 carry, card against
    CPU; ``bf16params_forecast`` (``CHAIN_STEPS`` DDPM steps) and
    ``bf16params_guided_forecast`` (50 guided DDIM steps, guidance f32: the
    net on its f32 copy) with the carry in bf16, each eager and on graphs,
    bit-equal, exact counts (the f32 chains' per step, the UNet's all bf16
    forms), no plain version called on the card, the guided one repeated bit
    for bit; the bf16 decode's ms beside the f32 one;
    ``bf16params_swin_forecast`` / ``bf16params_swin_guided_forecast`` on
    ``SWIN_PATTERN`` (guidance in bf16): every launch a bf16 form, rows 9,
    10 and 5 among them; ``bf16params_f32_carry``: the bf16 tree on an f32
    carry against the f32 pipeline on ``cast_to_fp32`` of it, bit for bit,
    no bf16 launch.  Returns the kernel cases and the chains' launches."""
    import copy

    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_unet
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.precision import cast_to_bf16, cast_to_fp32

    t_start = time.perf_counter()
    scfg, smodels = swin_models(cfg)
    swin = swin_cases(smodels["unet"], smodels["align"], cfg.optim.micro_batch_size)
    swin_per = path_launches(smodels["unet"], smodels["align"])
    pcases = bf16params_kernel_cases(cases, swin)
    rows13 = {k + "_bf16": pcases.get(k + "_bf16", []) for k in BF16_FORMS}
    t1 = time.perf_counter()
    bad = check_bf16_kernels(rows13, device) + check_bf16_cuboid_kernels(pcases, device)
    line = {"phase": "bf16params_kernels_vs_plain", "card": smi,
            "cases": sum(len(v) for v in pcases.values()), "failed": len(bad),
            "t_s": time.perf_counter() - t1}
    for name, cs in pcases.items():
        line[name] = [{k: c.get(k) for k in ("shape", "window", "max_rel_err", "ms", "device_ms",
                                             "f32_form_device_ms", "library_ms",
                                             "library_device_ms", "library_seq_device_ms",
                                             "equals_f32_form_rounded")
                       if k in c} | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]}
                      for c in cs]
    emit(line)
    if bad:
        fail(f"bf16 form disagrees with its plain version at the bf16-parameter shapes: {bad}")

    bf16 = torch.bfloat16
    w16 = cast_to_bf16(weights)
    pred16 = PreDiffPredictor(cfg, params=w16, with_alignment=True, device=device,
                              compute_dtype="bfloat16")
    p32 = PreDiffPredictor(cfg, params=cast_to_fp32(w16), with_alignment=True, device=device)
    d, img = cfg.model.diffusion, cfg.layout
    rs = torch.Generator().manual_seed(SEED + 19)

    # one UNet forward on a bf16 carry: the card (bf16 forms) against the CPU (plain versions)
    x = torch.randn((1,) + tuple(d.latent_shape), generator=rs).to(bf16)
    cond = torch.randn((1,) + tuple(d.latent_cond_shape), generator=rs).to(bf16)
    t = torch.tensor([500])
    unet_cpu = build_unet(cfg).to(bf16).eval().requires_grad_(False)
    unet_cpu.load_state_dict(w16["unet"])
    t1 = time.perf_counter()
    with torch.no_grad():
        ref = unet_cpu(x, t, cond)
        cpu_s = time.perf_counter() - t1
        counters_zero()
        got = pred16.ld.unet(x.to(device), t.to(device), cond.to(device))
        sync(device)
        counts = {**counters_read(), **bf16_counts()}
    del unet_cpu
    err = rel_l2_and_cosine([got.float()], [ref.float()])
    want = {k: per[k]["per_unet"] for k in KERNELS} | {k: 0 for k in BF16_KERNELS}
    want.update({k + "_bf16": per[k]["per_unet"] for k in BF16_FORMS + BF16_CUBOID_FORMS})
    emit({"phase": "bf16params_forward", "dtype": str(got.dtype), "rel_l2_err": err[0],
          "cosine": err[1], "tol_rel_l2": BF16PARAMS_FORWARD_TOL, "cpu_forward_s": cpu_s,
          "launches": counts, "expected_launches": want})
    if (got.dtype != bf16 or not torch.isfinite(got.float()).all()
            or err[0] > BF16PARAMS_FORWARD_TOL or counts != want):
        fail(f"bf16params_forward: {got.dtype}, rel-L2 {err[0]}, launches {counts} != {want}")

    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    avg = torch.tensor([[AVG_X_GT]]).numpy()
    install, plain_calls, remove = plain_spy()

    def read_all():
        return {**counters_read(), **bf16_counts()}

    def expected_by(per_, bf16_align):
        """Exact counts: the f32 chains' per step; the UNet's launches all bf16
        forms, the alignment net's too where ``bf16_align``."""
        def fn(steps, guided):
            out = {k: steps * (v["per_unet"] + (v["per_align"] if guided else 0))
                   for k, v in per_.items()} | {k: 0 for k in BF16_KERNELS}
            for k in BF16_FORMS + BF16_CUBOID_FORMS:
                v = per_[k]
                out[k + "_bf16"] = steps * (v["per_unet"]
                                            + (v["per_align"] if guided and bf16_align else 0))
            return out
        return fn

    guided_kw = dict(ddim_steps=BF16PARAMS_DDIM_STEPS, use_alignment=True, avg_x_gt=avg)
    warm_shift(pred16, d, device)
    install()
    try:
        launches = run_chains(pred16, context, {
            "bf16params_forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
            "bf16params_guided_forecast": (guided_kw, BF16PARAMS_DDIM_STEPS, True)},
            expect_shape, expected_by(per, False), device, smi, counters_zero, read_all)
        repeat = [pred16.predict(context, generator=torch.Generator(device).manual_seed(SEED),
                                 **guided_kw) for _ in range(2)]
        calls = plain_calls()
    finally:
        remove()
    zl = torch.randn((1,) + tuple(d.latent_shape), device=device)
    decode_ms = time_ms(lambda: pred16.ld.decode_first_stage(zl.to(bf16)), warmup=1, iters=5)
    decode_f32_ms = time_ms(lambda: p32.ld.decode_first_stage(zl), warmup=1, iters=5)
    line = {"phase": "bf16params_chains", "card": smi, "plain_calls_on_card": calls[0],
            "guided_repeats_bit_for_bit": torch.equal(repeat[0], repeat[1]),
            "output_dtype": str(repeat[0].dtype), "decode_ms": decode_ms,
            "decode_f32_ms": decode_f32_ms,
            "ms_per_step": {k: GRAPH_CHAINS[k]["ms_per_step"] for k in (
                "forecast", "ddim_forecast", "bf16params_forecast", "bf16params_guided_forecast")
                if k in GRAPH_CHAINS},
            "device_ms_per_step": {k: GRAPH_CHAINS[k]["device_ms_per_step"] for k in (
                "forecast", "ddim_forecast", "bf16params_forecast", "bf16params_guided_forecast")
                if k in GRAPH_CHAINS}}
    emit(line)
    if calls[0] or not line["guided_repeats_bit_for_bit"]:
        fail(f"bf16params chains: plain versions called on the card {calls[0]}, or the guided "
             "forecast does not repeat bit for bit")

    # the swin pattern on bf16 parameters, guidance in bf16: rows 9, 10 and 5 in their bf16 forms
    scfg16 = ConfigDict.wrap(deep_merge(scfg.to_dict(), {"model": {"align": {
        "compute_dtype": "bfloat16"}}}))
    spred = PreDiffPredictor(scfg16, params=cast_to_bf16({k: m.state_dict()
                                                          for k, m in smodels.items()}),
                             with_alignment=True, device=device, compute_dtype="bfloat16")
    warm_shift(spred, d, device)
    install()
    try:
        launches.update(run_chains(spred, context, {
            "bf16params_swin_forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
            "bf16params_swin_guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                                     avg_x_gt=avg), CHAIN_STEPS, True)},
            expect_shape, expected_by(swin_per, True), device, smi, counters_zero, read_all))
        calls = plain_calls()
    finally:
        remove()
    per_step = {k + "_bf16": {"per_unet": swin_per[k]["per_unet"],
                              "per_align": swin_per[k]["per_align"]} for k in BF16_CUBOID_FORMS}
    emit({"phase": "bf16params_swin", "pattern": SWIN_PATTERN, "card": smi,
          "plain_calls_on_card": calls[0], "recomputed_on_card": calls[1],
          "cuboid_forms_per_step": per_step})
    if calls[0] or not all(launches["bf16params_swin_guided_forecast"][k + "_bf16"]
                           for k in BF16_CUBOID_FORMS):
        fail(f"bf16params_swin: plain versions called on the card {calls[0]}, or a cuboid "
             f"kernel's bf16 form did not launch: {launches['bf16params_swin_guided_forecast']}")
    del spred, smodels

    # the bf16 tree on an f32 carry: the f32 network on a copy of the rounded weights
    f32carry = copy.copy(pred16)
    f32carry.compute_dtype = "float32"
    line = {"phase": "bf16params_f32_carry", "card": smi, "steps": BF16PARAMS_F32_CARRY_STEPS}
    ok = True
    for label, kw in (("ddpm", dict(timesteps=BF16PARAMS_F32_CARRY_STEPS)),
                      ("guided_ddim", dict(ddim_steps=BF16PARAMS_F32_CARRY_STEPS,
                                           use_alignment=True, avg_x_gt=avg))):
        counters_zero()
        a = f32carry.predict(context, generator=torch.Generator(device).manual_seed(SEED), **kw)
        sync(device)
        forms = bf16_counts()
        b = p32.predict(context, generator=torch.Generator(device).manual_seed(SEED), **kw)
        line[label] = {"bit_equal": torch.equal(a, b), "dtype": str(a.dtype),
                       "finite": bool(torch.isfinite(a).all()),
                       "bf16_launches": sum(forms.values())}
        ok = ok and torch.equal(a, b) and a.dtype == torch.float32 and not any(forms.values())
    line["unet_copies"] = [str(next(m.parameters()).dtype) for m in pred16.ld._unet.copies()]
    emit(line)
    if not ok:
        fail(f"bf16params_f32_carry: the bf16 tree on an f32 carry differs from the f32 "
             f"pipeline on the rounded weights: {line}")
    emit({"phase": "bf16params", "t_s": time.perf_counter() - t_start})
    del pred16, p32, f32carry
    return pcases, launches


def bf16params_alone(device, smi):
    """``--only bf16params``: the seeded full-width models as ``run`` makes
    them, the f32 ``forecast`` and ``ddim_forecast`` (the numbers the bf16
    chains are read beside), ``bf16params_phases`` and the new forms'
    ``kernels`` line."""
    import torch
    from prediff_torch.config import alignment_default_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    cfg = prediff_default_config()
    kernel_counters()
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(cfg), gen, randomize=True).eval().requires_grad_(False)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    weights = {k: m.state_dict() for k, m in models.items()}
    cases = kernel_cases(models["unet"], models["align"], cfg.optim.micro_batch_size,
                         alignment_default_config().optim.micro_batch_size)
    by_route = path_launches(models["unet"], models["align"])
    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device)
    img = cfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=torch.Generator().manual_seed(SEED + 1))
    run_chains(predictor, context, {
        "forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "ddim_forecast": (dict(ddim_steps=BF16PARAMS_DDIM_STEPS, use_alignment=True,
                               avg_x_gt=torch.tensor([[AVG_X_GT]]).numpy()),
                          BF16PARAMS_DDIM_STEPS, True)},
        (1, img.out_len, img.img_height, img.img_width, img.data_channels),
        lambda steps, guided: expected_launches(cases, steps, guided), device, smi,
        counters_zero, counters_read)
    del predictor
    pcases, launches = bf16params_phases(device, cfg, smi, weights, cases, by_route)
    emit({"kernels": summarize({k: v for k, v in pcases.items()
                                if k[:-5] in BF16_CUBOID_FORMS}, launches)})


def vae_train_bf16_phases(device, smi):
    """The VAE-GAN trainer with ``optim.vae_compute_dtype: bfloat16``
    (``factory.build_vae_trainer``): the VAE's encode and decode on its
    parameters cast to bf16, the rest f32.  ``vae_train_bf16_grads``: one
    step's losses and both states' gradients at B=1 and ``disc_start`` 0,
    card against CPU (bf16 convolutions on both sides) with the same
    posterior noise: the losses within 1e-2, the adaptive weight and the
    total within 5e-2, the gradients at cosine >= 0.99 and no further from
    the f32 step's (CPU) than ``VAE_BF16_GRAD_DRIFT_SHARE`` times the CPU bf16
    step's distance plus 1e-2; then twice on the card at the micro-batch,
    bit-equal.
    ``vae_train_bf16``: ``VAE_TRAIN_STEPS`` steps at the micro-batch at the
    recipe's ``disc_start`` and at 0, ms per step, frames/s, the profiler's
    busy share, peak memory, the stored parameters still f32, beside the
    same run's f32 ``vae_train``."""
    import numpy as np
    import torch
    from prediff_torch.config import vae_training_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_discriminator, build_vae, build_vae_trainer
    from prediff_torch.models.init import init_params_
    from prediff_torch.utils.distributions import DiagonalGaussianDistribution

    cfg = vae_training_default_config()
    cfg.optim.vae_compute_dtype = "bfloat16"
    B, H, W = cfg.optim.micro_batch_size, cfg.layout.img_height, cfg.layout.img_width
    gen = torch.Generator().manual_seed(SEED)
    weights = {"vae": init_params_(build_vae(cfg), gen).state_dict(),
               "disc": build_discriminator(cfg).reset_parameters(gen).state_dict()}
    frames = torch.from_numpy(next(synthetic_batch_iterator(B, 1, H, W, seed=SEED + 4))[:, 0])
    down = 2 ** (len(cfg.model.vae.block_out_channels) - 1)
    eps = torch.randn((B, H // down, W // down, cfg.model.vae.latent_channels),
                      generator=torch.Generator().manual_seed(SEED + 5))

    def trainer_on(dev, disc_start):
        trainer = build_vae_trainer(cfg, device=dev, params=weights, seed=SEED)
        trainer.disc_start = disc_start
        return trainer, trainer.create_states()

    sample = DiagonalGaussianDistribution.sample
    t1 = time.perf_counter()
    out = {}
    try:   # the posterior's sample with the same noise on both sides
        for dev, dtype in (("cpu", "bfloat16"), ("cpu", None), (device, "bfloat16")):
            DiagonalGaussianDistribution.sample = (
                lambda self, generator=None: self.mean + self.std * eps[:1].to(self.mean.device))
            trainer, (g_state, d_state, _) = trainer_on(dev, 0)
            trainer.compute_dtype = None if dtype is None else torch.bfloat16
            g, d, logs = trainer.grads(g_state, d_state, SEED, frames[:1].to(dev))
            out[(str(dev), dtype)] = (g, d, {k: float(v) for k, v in logs.items()})
            if len(out) == 1:
                cpu_s = time.perf_counter() - t1
            del trainer, g_state, d_state
    finally:
        DiagonalGaussianDistribution.sample = sample
    (g_cpu, d_cpu, logs_cpu) = out[("cpu", "bfloat16")]
    (g_card, d_card, logs_card) = out[(str(device), "bfloat16")]
    g32, d32, _ = out[("cpu", None)]
    drift = {"cpu_bf16": (rel_l2_and_cosine(g_cpu, g32)[0], rel_l2_and_cosine(d_cpu, d32)[0]),
             "card_bf16": (rel_l2_and_cosine(g_card, g32)[0], rel_l2_and_cosine(d_card, d32)[0])}
    drift_ok = all(c <= VAE_BF16_GRAD_DRIFT_SHARE * r + 1e-2
                   for c, r in zip(drift["card_bf16"], drift["cpu_bf16"]))
    loss_rel = {k: abs(logs_card[k] - logs_cpu[k]) / abs(logs_cpu[k])
                for k in ("train/disc_loss", "train/nll_loss", "train/kl_loss",
                          "train/g_loss", "train/rec_loss")}
    # the adaptive weight is a ratio of two gradient norms through the bf16
    # features, and the total carries it times g_loss: held at the gradients' bar
    weight_rel = {k: abs(logs_card[k] - logs_cpu[k]) / abs(logs_cpu[k])
                  for k in ("train/d_weight", "train/total_loss")}
    gen_err, disc_err = rel_l2_and_cosine(g_card, g_cpu), rel_l2_and_cosine(d_card, d_cpu)
    finite = all(torch.isfinite(t).all() for t in (*g_card, *d_card))
    trainer, (g_state, d_state, _) = trainer_on(device, 0)
    x = frames.to(device)
    a = trainer.grads(g_state, d_state, SEED, x)
    b = trainer.grads(g_state, d_state, SEED, x)
    bit_equal = (all(torch.equal(u, v) for u, v in zip((*a[0], *a[1]), (*b[0], *b[1])))
                 and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))
    del trainer, g_state, d_state, a, b
    emit({"phase": "vae_train_bf16_grads", "batch_cpu": 1, "batch_card": B, "frames": [H, W],
          "compute_dtype": "bfloat16", "disc_start": 0, "logs_card": logs_card,
          "logs_cpu": logs_cpu, "loss_rel_err": loss_rel, "tol_loss_rel": VAE_BF16_LOSS_TOL_REL,
          "weight_rel_err": weight_rel, "tol_weight_rel": VAE_BF16_GRAD_TOL_REL_L2,
          "gen_grad_rel_l2_err": gen_err[0], "gen_grad_cosine": gen_err[1],
          "disc_grad_rel_l2_err": disc_err[0], "disc_grad_cosine": disc_err[1],
          "min_cosine": VAE_BF16_GRAD_MIN_COSINE,
          "grad_rel_l2_to_f32": drift, "drift_share": VAE_BF16_GRAD_DRIFT_SHARE,
          "bit_equal_across_two_runs": bit_equal, "cpu_step_s": cpu_s})
    if not finite:
        fail("vae_train_bf16_grads: non-finite gradient on the card")
    if (max(loss_rel.values()) > VAE_BF16_LOSS_TOL_REL
            or max(weight_rel.values()) > VAE_BF16_GRAD_TOL_REL_L2 or not drift_ok
            or min(gen_err[1], disc_err[1]) < VAE_BF16_GRAD_MIN_COSINE):
        fail(f"vae_train_bf16_grads: card differs from the CPU: losses {loss_rel}, generator "
             f"gradient {gen_err}, discriminator gradient {disc_err}")
    if not bit_equal:
        fail("vae_train_bf16_grads: two runs of the same step on the card differ")

    for disc_start in (cfg.model.loss.disc_start, 0):
        trainer, (g_state, d_state, stats) = trainer_on(device, disc_start)
        torch.cuda.reset_peak_memory_stats(device)
        steps = []
        for _ in range(VAE_TRAIN_STEPS):
            sync(device)
            t0 = time.perf_counter()
            g_state, d_state, stats, logs = trainer.train_step(g_state, d_state, stats, SEED, x)
            sync(device)
            steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                          **{k.split("/")[1]: float(v) for k, v in logs.items()}})
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        steady = sorted(st["ms"] for st in steps[1:])
        ms = steady[len(steady) // 2]
        prof = profile("profile_vae_train_bf16_step",
                       lambda: trainer.train_step(g_state, d_state, stats, SEED, x), reps=2)
        stored_f32 = all(p.dtype == torch.float32 for p in g_state.params.values())
        f32 = PHASE_NUMBERS.get(("vae_train", disc_start), {})
        emit({"phase": "vae_train_bf16", "batch": B, "frames": [H, W], "disc_start": disc_start,
              "compute_dtype": "bfloat16", "steps": steps, "ms_per_step": ms,
              "frames_per_s": 1e3 * B / ms, "device_busy_share": prof["device_busy_share"],
              "device_ms_per_step": prof["device_ms_per_call"], "peak_mem_gib": peak,
              "stored_params_f32": stored_f32, "f32_ms_per_step": f32.get("ms_per_step"),
              "f32_frames_per_s": f32.get("frames_per_s"), "f32_peak_mem_gib": f32.get("peak"),
              "card": smi})
        if disc_start == 0:
            emit(prof)
        if not stored_f32 or not all(np.isfinite(v) for st in steps for v in st.values()):
            fail("vae_train_bf16: a stored parameter left f32, or a non-finite loss")
        del trainer, g_state, d_state, stats


# eval_suite: JAX run_eval's "unaligned" and "aligned" suites over an ensemble
# forecast; data_prefetch: training batches through prefetch_to_device
EVAL_BATCH = 2            # contexts and targets
EVAL_MEMBERS = 2          # ensemble members a context
EVAL_DDIM_STEPS = 50
EVAL_I3D_CLASSES = 400
EVAL_TOL_REL = {"mse": 1e-6, "mae": 1e-6, "crps": 1e-6, "ssim": 1e-5, "fvd": 1e-3}
EVAL_FEATURES_REL_L2 = 1e-4
# compute()'s keys after the prefix, for the v1 recipe's thresholds and metrics
EVAL_KEYS = (
    "mse_epoch", "mae_epoch", "ssim_epoch",
    "csi_16_epoch", "csi_74_epoch", "csi_133_epoch", "csi_160_epoch", "csi_181_epoch",
    "csi_219_epoch", "csi_avg_epoch",
    "pod_16_epoch", "pod_74_epoch", "pod_133_epoch", "pod_160_epoch", "pod_181_epoch",
    "pod_219_epoch", "pod_avg_epoch",
    "sucr_16_epoch", "sucr_74_epoch", "sucr_133_epoch", "sucr_160_epoch", "sucr_181_epoch",
    "sucr_219_epoch", "sucr_avg_epoch",
    "bias_16_epoch", "bias_74_epoch", "bias_133_epoch", "bias_160_epoch", "bias_181_epoch",
    "bias_219_epoch", "bias_avg_epoch",
    "loss_epoch", "crps_epoch", "fvd_epoch")
# the kernels an ensemble forecast launches (PERF.md rows 1-4, 6, 7, 14): unguided, guided
EVAL_KERNELS = {"test": ("groupnorm_silu", "ffn", "axial_attention"),
                "test_aligned": ("groupnorm_silu", "ffn", "axial_attention",
                                 "axial_attention_bwd_dx", "ffn_bwd_dx", "resblock",
                                 "resblock_bwd", "groupnorm_silu_bwd_full")}
PREFETCH_BATCHES = 6


def eval_suites(cfg, feature_fn):
    """The "unaligned" and "aligned" suites of JAX ``run_eval``, by prefix,
    over one FVD extractor."""
    from prediff_torch.evaluation import ForecastEvalSuite, FrechetVideoDistance

    return {prefix: ForecastEvalSuite(
        layout=cfg.layout.layout, metrics_mode=cfg.dataset.metrics_mode,
        seq_len=cfg.layout.out_len, threshold_list=tuple(cfg.dataset.threshold_list),
        metrics_list=tuple(cfg.dataset.metrics_list),
        fvd=FrechetVideoDistance(feature_fn=feature_fn, num_features=EVAL_I3D_CLASSES,
                                 auto_t=True, reset_real_features=False))
        for prefix in ("test", "test_aligned")}


def i3d_gflop(model, video_shape) -> float:
    """The I3D's convolution GFLOP (2 x multiply-adds) on one video of
    ``video_shape`` (T, H, W, C) after ``preprocess_video``, from a CPU
    forward's output shapes."""
    import torch

    flop = []

    def count(m, _, out):
        flop.append(2.0 * out.numel() * m.weight[0].numel())

    hooks = [m.register_forward_hook(count) for m in model.modules()
             if isinstance(m, torch.nn.Conv3d)]
    try:
        with torch.no_grad():
            model(torch.zeros((1,) + tuple(video_shape)))
    finally:
        for h in hooks:
            h.remove()
    return sum(flop) / 1e9


def eval_suite(device, smi, predictor, cfg, zero_counts, read_counts):
    """The ``eval_suite`` phase: ``predict_ensemble`` (``EVAL_MEMBERS``
    members of ``EVAL_BATCH`` synthetic contexts, ``EVAL_DDIM_STEPS`` DDIM
    steps) unguided and guided toward ``get_alignment_kwargs_avg_x`` of the
    target, each scored on the card by its suite (one seeded
    ``InceptionI3d(400)`` at 224x224 shared by both FVDs), then the same
    tensors on the CPU by suites built the same way.  Checks: the chains'
    kernels launched; counts equal, MSE / MAE / CRPS / SSIM / FVD within
    ``EVAL_TOL_REL``, the I3D features rel-L2 <= ``EVAL_FEATURES_REL_L2``,
    every value finite, the keys ``EVAL_KEYS`` under each prefix.  Times: the
    chains' ms per step (the step loop alone, captures out), ms per
    ``suite.update`` (after a first update at the same shapes, timed apart),
    ms per I3D video, and the suites' share of an evaluated forecast."""
    import numpy as np
    import torch
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
    from prediff_torch.evaluation import i3d_feature_fn, seeded_i3d

    img = cfg.layout
    batch = next(synthetic_batch_iterator(batch_size=EVAL_BATCH,
                                          seq_len=img.in_len + img.out_len, H=img.img_height,
                                          W=img.img_width, seed=SEED + 17))
    context = torch.from_numpy(batch[:, :img.in_len])
    target = torch.from_numpy(batch[:, img.in_len:]).to(device)
    avg_x_gt = get_alignment_kwargs_avg_x(target)["avg_x_gt"]
    i3d = seeded_i3d(EVAL_I3D_CLASSES, seed=SEED)
    feature_fn = i3d_feature_fn(i3d, cfg.eval.fvd_resolution)
    suites = eval_suites(cfg, feature_fn)
    # a first update at the same shapes, on a suite thrown away, timed apart: the
    # extractor's copy on the card and cuDNN's plans for each convolution's shape
    sync(device)
    t1 = time.perf_counter()
    eval_suites(cfg, feature_fn)["test"].update(target.expand((EVAL_MEMBERS,) + target.shape),
                                                target)
    sync(device)
    first_update_ms = 1e3 * (time.perf_counter() - t1)

    ld = predictor.ld
    chain, loop_s = ld._chain, []

    def timed_chain(*args):
        sync(device)
        t1 = time.perf_counter()
        ends = chain(*args)
        sync(device)
        loop_s.append(time.perf_counter() - t1)
        return ends

    preds, forecast_s, update_ms, launches, chain_ms = {}, {}, {}, {}, {}
    ld._chain = timed_chain
    try:
        for prefix, kw in (("test", {}), ("test_aligned", dict(use_alignment=True,
                                                               avg_x_gt=avg_x_gt))):
            capture_s = ld.graphs.capture_seconds
            sync(device)
            zero_counts()
            t1 = time.perf_counter()
            preds[prefix] = predictor.predict_ensemble(
                context, num_samples=EVAL_MEMBERS, ddim_steps=EVAL_DDIM_STEPS,
                generator=torch.Generator(device).manual_seed(SEED), **kw)
            sync(device)
            forecast_s[prefix] = time.perf_counter() - t1
            launches[prefix] = read_counts()
            chain_ms[prefix] = 1e3 * (loop_s[-1] - (ld.graphs.capture_seconds - capture_s)
                                      ) / EVAL_DDIM_STEPS
            t1 = time.perf_counter()
            suites[prefix].update(preds[prefix], target)
            sync(device)
            update_ms[prefix] = 1e3 * (time.perf_counter() - t1)
    finally:
        del ld._chain

    # the same tensors on the CPU, through suites built the same way
    cpu_suites = eval_suites(cfg, feature_fn)
    t1 = time.perf_counter()
    for prefix, suite in cpu_suites.items():
        suite.update(preds[prefix].cpu(), target.cpu())
    cpu_update_s = time.perf_counter() - t1

    # the I3D features of the aligned suite's videos (auto_t: T=12; tiled to 3 channels)
    videos = torch.cat([preds["test_aligned"].flatten(0, 1), target])
    videos = torch.repeat_interleave(videos, -(-9 // videos.shape[1]), dim=1).repeat(
        1, 1, 1, 1, 3)
    feats = feature_fn(videos).cpu().numpy()
    feats_cpu = feature_fn(videos.cpu()).numpy()
    features_rel_l2 = float(np.linalg.norm(feats - feats_cpu) / np.linalg.norm(feats_cpu))
    per_video_ms = time_ms(lambda: feature_fn(videos), warmup=1, iters=3) / videos.shape[0]
    gflop = i3d_gflop(i3d, (videos.shape[1], cfg.eval.fvd_resolution,
                            cfg.eval.fvd_resolution, 3))

    computed, errors_by_key, bad = {}, {}, []
    for prefix, suite in suites.items():
        got, want = suite.compute(prefix), cpu_suites[prefix].compute(prefix)
        computed[prefix] = got
        if set(got) != {f"{prefix}_{k}" for k in EVAL_KEYS} or set(want) != set(got):
            bad.append(f"{prefix}: keys {sorted(got)}")
        for name in ("hits", "misses", "fas"):
            if not torch.equal(getattr(suite.score.state, name).cpu(),
                               getattr(cpu_suites[prefix].score.state, name)):
                bad.append(f"{prefix}: {name} card != CPU")
        for k, v in got.items():
            if not np.isfinite(v):
                bad.append(f"{k} = {v}")
            metric = k[len(prefix) + 1:].split("_")[0]
            if metric in EVAL_TOL_REL:
                err = abs(v - want[k]) / max(abs(want[k]), 1e-30)
                errors_by_key[k] = err
                if not err <= EVAL_TOL_REL[metric]:
                    bad.append(f"{k}: card {v} CPU {want[k]} (rel {err:.3g})")
        for kernel in EVAL_KERNELS[prefix]:
            if launches[prefix][kernel] == 0:
                bad.append(f"{prefix}: {kernel} launched no time")
    if not features_rel_l2 <= EVAL_FEATURES_REL_L2:
        bad.append(f"I3D features card vs CPU rel-L2 {features_rel_l2:.3g}")
    shape = (EVAL_MEMBERS, EVAL_BATCH, img.out_len, img.img_height, img.img_width,
             img.data_channels)
    if any(tuple(p.shape) != shape or not torch.isfinite(p).all() for p in preds.values()):
        bad.append(f"forecasts: shapes {[tuple(p.shape) for p in preds.values()]} (want "
                   f"{shape}) or non-finite values")
    evaluated_s = sum(forecast_s.values()) + sum(update_ms.values()) / 1e3
    emit({"phase": "eval_suite", "card": smi, "batch": EVAL_BATCH, "members": EVAL_MEMBERS,
          "ddim_steps": EVAL_DDIM_STEPS, "chain_ms_per_step": chain_ms,
          "forecast_s": forecast_s, "suite_update_ms": update_ms,
          "suite_share_of_evaluated_forecast": sum(update_ms.values()) / 1e3 / evaluated_s,
          "first_update_ms": first_update_ms, "i3d_ms_per_video": per_video_ms, "i3d_input_shape": list(videos.shape[1:]),
          "i3d_resolution": cfg.eval.fvd_resolution,
          "i3d_gflop_per_video": gflop, "i3d_tflop_per_s": gflop / per_video_ms,
          "i3d_bound_ms_f32": gflop * 1e9 / F32_FLOP_PER_S * 1e3,
          "cpu_update_s": cpu_update_s, "features_rel_l2": features_rel_l2,
          "rel_err": errors_by_key, "tol_rel": EVAL_TOL_REL, "launches": launches,
          "compute": computed, "failed": bad})
    if bad:
        fail(f"eval_suite: {bad}")


def data_prefetch(device, smi, cfg, weights):
    """The ``data_prefetch`` phase: synthetic training batches augmented on
    the host (``augment_seq`` mode "2" as the ``transform``) through
    ``prefetch_to_device``: the first ``PREFETCH_BATCHES`` bit-equal to the
    host batches, on the card, each staged through pinned memory (a spy on
    ``prefetch.pinned``); the diffusion trainer's ``val_step`` at the
    micro-batch size fed by the prefetch and by blocking copies in the loop
    (the host's augmentation and copy in the step's way) gives bit-equal
    losses; ms per step both ways, the steps' device ms (inputs already on
    the card, CUDA events), each way's busy share, and the host's ms to make
    and augment a batch."""
    import numpy as np
    import torch
    from prediff_torch.datasets import augment_seq, prefetch
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    img = cfg.layout
    B = cfg.optim.micro_batch_size

    def source():
        return synthetic_batch_iterator(batch_size=B, seq_len=img.in_len + img.out_len,
                                        H=img.img_height, W=img.img_width, seed=SEED + 23,
                                        num_batches=PREFETCH_BATCHES)

    def augmenter():
        rng = np.random.default_rng(SEED)
        return lambda b: np.stack([augment_seq(s, "THWC", "2", rng) for s in b])

    aug = augmenter()
    t1 = time.perf_counter()
    host = [aug(b) for b in source()]
    host_ms = 1e3 * (time.perf_counter() - t1) / PREFETCH_BATCHES
    staged = []
    pinned = prefetch.pinned

    def spy(t):
        p = pinned(t)
        staged.append(p.is_pinned())
        return p

    prefetch.pinned = spy
    try:
        fed = list(prefetch.prefetch_to_device(source(), size=2, device=device,
                                               transform=augmenter()))
    finally:
        prefetch.pinned = pinned
    equal = all(torch.equal(f.cpu(), torch.from_numpy(h)) for f, h in zip(fed, host))
    on_card = all(f.device == device for f in fed)

    ld = build_training_pipeline(cfg, device=device, params=weights)
    trainer = DiffusionTrainer(ld, optim_config=dict(lr=cfg.optim.lr, total_num_steps=100))
    state = trainer.create_state()

    def step(b):
        return trainer.val_step(state, SEED, b[:, img.in_len:], b[:, :img.in_len])

    step(fed[0])   # warm-up: cuDNN picks its algorithms for these shapes
    runs = {}
    for way in ("prefetch", "blocking", "blocking", "prefetch"):
        sync(device)
        t1 = time.perf_counter()
        if way == "prefetch":
            losses = [step(b) for b in prefetch.prefetch_to_device(
                source(), size=2, device=device, transform=augmenter())]
        else:
            a = augmenter()
            losses = [step(torch.from_numpy(a(b)).to(device)) for b in source()]
        losses = [{k: v.cpu() for k, v in m.items()} for m in losses]
        runs.setdefault(way, []).append((1e3 * (time.perf_counter() - t1) / len(losses),
                                         losses))
    bit_equal = all(set(p) == set(q) and all(torch.equal(p[k], q[k]) for k in p)
                    for (_, lp) in runs["prefetch"] for (_, lb) in runs["blocking"]
                    for p, q in zip(lp, lb))
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for b in fed:
        step(b)
    stop.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(stop) / len(fed)
    ms = {way: [r[0] for r in rs] for way, rs in runs.items()}
    ok = (equal and on_card and staged == [True] * PREFETCH_BATCHES
          and len(fed) == PREFETCH_BATCHES and bit_equal)
    emit({"phase": "data_prefetch", "card": smi, "batch": B, "batches": PREFETCH_BATCHES,
          "bit_equal_to_host": equal, "on_card": on_card, "pinned": staged,
          "val_losses_bit_equal": bit_equal, "host_ms_per_batch": host_ms,
          "ms_per_step": ms, "device_ms_per_step": device_ms,
          "busy_share": {way: device_ms / float(np.median(v)) for way, v in ms.items()},
          "val_loss": float(runs["prefetch"][0][1][0]["val/loss"]), "ok": ok})
    if not ok:
        fail("data_prefetch: batches differ from the host's, are off the card or not from "
             "pinned memory, or the losses differ between the two feeds")


def eval_data_alone(device, smi, names):
    """``--only eval,data``: the seeded full-width models as ``run`` makes
    them, then ``eval_suite`` and / or ``data_prefetch``."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    cfg = prediff_default_config()
    zero_counts, read_counts = kernel_counters()
    gen = torch.Generator().manual_seed(SEED)
    weights = {key: init_params_(build(cfg), gen, randomize=True).state_dict()
               for key, build in (("unet", build_unet), ("vae", build_vae),
                                  ("align", build_alignment_model))}
    if "eval" in names:
        predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device)
        eval_suite(device, smi, predictor, cfg, zero_counts, read_counts)
        del predictor
    if "data" in names:
        data_prefetch(device, smi, cfg, {"unet": weights["unet"], "vae": weights["vae"]})


# --------------------------------------------------------------------------- #
# The model variants the JAX package builds from its configuration.  The FFN
# kernels' activations (rows 2, 6, 12, 15a, 15b and the bf16 forms of rows 2
# and 6) enter the kernels line as entries of their own, "<kernel>_<act>" and
# "<kernel>_<act>_bf16", with the launches of the phase named here (None: on
# no path, launches 0).
VARIANT_ACTS = ("relu", "leaky", "silu")
ACT_FORMS = ("ffn", "ffn_bwd_dx", "ffn_bwd_full", "ffn_dropout", "ffn_dropout_bwd_full")
ACT_PATHS = {"ffn": {"relu": "variant_vs_cpu", "leaky": "variant_guided_forecast",
                     "silu": "variant_guided_forecast"},
             "ffn_bwd_dx": {"relu": "variant_vs_cpu", "leaky": "variant_vs_cpu",
                            "silu": "variant_guided_forecast"},
             "ffn_bwd_full": {a: "variant_vs_cpu" for a in VARIANT_ACTS},
             "ffn_dropout": {"relu": None, "leaky": "variant_train", "silu": "variant_train"},
             "ffn_dropout_bwd_full": {"relu": None, "leaky": "variant_train",
                                      "silu": "variant_train"}}
ACT_KERNELS = {f"{k}_{a}": KERNELS[k][:2] + (ACT_PATHS[k][a],)
               for k in ACT_FORMS for a in VARIANT_ACTS}
ACT_KERNELS.update({f"{k}_{a}_bf16": KERNELS[k][:2] + (None,)
                    for k in ("ffn", "ffn_bwd_dx") for a in VARIANT_ACTS})
PATH_WEIGHTS.update({p: ("per_variant",) for p in ("variant_guided_forecast", "variant_vs_cpu",
                                                   "variant_train")})
VARIANT_FFN_SHAPES = ((3328, 256), (832, 512))   # the UNet's FFN shapes at B=1
VARIANT_STEPS = 4        # DDPM steps of the variant chains
# the variant configurations at v1's widths (variant_kernels, variant_globals,
# variant_align), and the alignment nets held card against CPU alone
VARIANT_UNETS = {
    "variant_kernels": dict(ffn_activation="leaky", use_relative_pos=False,
                            pos_embed_type="t+hw", time_embed_use_scale_shift_norm=True,
                            attn_linear_init_mode="1", conv_init_mode="1"),
    "variant_globals": dict(num_global_vectors=8, use_global_self_attn=True,
                            separate_global_qkv=True, global_dim_ratio=1, pos_embed_type="t+hw"),
}
VARIANT_ALIGNS = {
    "variant_align": dict(hierarchical_pos_embed=True, use_inter_ffn=False,
                          self_attn_use_final_proj=False, ffn_activation="silu"),
    "variant_align_relu_globals_pooled": dict(ffn_activation="relu", num_global_vectors=4,
                                              readout_seq=False),
    "variant_align_gated": dict(gated_ffn=True, ffn_activation="leaky"),
}


def act_counts():
    """The FFN kernels' launches on relu / leaky / silu since the counts were
    last set to 0, as ``<kernel>_<act>``."""
    return {f"{k}_{a}": getattr(COUNTERS[k], f"{a}_launches")
            for k in ACT_FORMS for a in VARIANT_ACTS}


def variant_config(cfg, latent=None, align=None):
    """``cfg`` with ``latent``'s settings of the UNet and ``align``'s of the alignment net."""
    from prediff_torch.config import ConfigDict, deep_merge

    return ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": latent or {}, "align": {"model_args": align or {}}}}))


def check_activation_kernels(device):
    """``ffn_activations``: each FFN kernel, its dropout forms and the bf16
    forms of rows 2 and 6 on relu, leaky and silu, against its plain version
    at the UNet's two FFN shapes, with the GELU forms' bars (the dropout
    forms also at a ``DROP_BASES`` base); times, device times, the bound and
    the library sequence's time.  Returns the cases by entry."""
    import torch
    from prediff_torch.ops import ffn as F_

    gen = torch.Generator(device=device).manual_seed(SEED + 22)
    bf16 = torch.bfloat16
    names = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")
    drop = (DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
    cases = {}

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    for act in VARIANT_ACTS:
        kw = dict(activation=act)
        for M, C in VARIANT_FFN_SHAPES:
            hid = 4 * C
            for form in ACT_FORMS + ("ffn_bf16", "ffn_bwd_dx_bf16"):
                dt = bf16 if form.endswith("_bf16") else torch.float32
                x, g = randn(M, C, dtype=dt), randn(M, C, dtype=dt)
                ln_w, ln_b = 1.0 + randn(C, scale=0.1, dtype=dt), randn(C, scale=0.1, dtype=dt)
                w1, b1 = randn(hid, C, scale=C ** -0.5, dtype=dt), randn(hid, scale=0.1, dtype=dt)
                w2, b2 = randn(C, hid, scale=hid ** -0.5, dtype=dt), randn(C, scale=0.1, dtype=dt)
                fwd, bwd = (x, ln_w, ln_b, w1, b1, w2, b2), (x, g, ln_w, ln_b, w1, b1, w2)
                c = {"shape": [M, C], "activation": act, "per_variant": 1}
                fw_bytes = 4 * (2 * M * C + 2 * C * hid + hid + 3 * C)
                bw_bytes = 4 * (3 * M * C + 4 * C * hid + 2 * hid + 5 * C)
                if form == "ffn":
                    got, want = F_.fused_ffn(*fwd, **kw), F_.ffn_plain(*fwd, mxu_dtype=bf16, **kw)
                    judge(c, got, want, tol=2e-2)
                    timed(c, lambda: F_.fused_ffn(*fwd, **kw),
                          lambda: F_.ffn_plain(*fwd, mxu_dtype=bf16, **kw), fw_bytes,
                          device_time=True, library_seq=ffn_library_seq(*fwd, act=act),
                          bf16_flops=4 * M * C * hid)
                elif form == "ffn_bwd_dx":
                    got = F_.fused_ffn_bwd_dx(*bwd, **kw)
                    judge(c, got, F_.ffn_bwd_dx_plain(*bwd, mxu_dtype=bf16, **kw))
                    timed(c, lambda: F_.fused_ffn_bwd_dx(*bwd, **kw),
                          lambda: F_.ffn_bwd_dx_plain(*bwd, mxu_dtype=bf16, **kw),
                          4 * (3 * M * C + 2 * C * hid + hid + 2 * C), device_time=True,
                          bf16_flops=6 * M * C * hid)
                elif form == "ffn_bwd_full":
                    got = F_.fused_ffn_bwd_full(*bwd, **kw)
                    judge_all(c, names, got, F_.ffn_bwd_full_plain(*bwd, mxu_dtype=bf16, **kw))
                    timed(c, lambda: F_.fused_ffn_bwd_full(*bwd, **kw),
                          lambda: F_.ffn_bwd_full_plain(*bwd, mxu_dtype=bf16, **kw), bw_bytes,
                          device_time=True, bf16_flops=10 * M * C * hid)
                elif form == "ffn_dropout":
                    args = fwd + (1e-5,)
                    got = F_.fused_ffn_dropout(*args, *drop, **kw)
                    judge(c, got, F_.ffn_dropout_plain(*args, *drop, mxu_dtype=bf16, **kw),
                          tol=2e-2)
                    judge_drop(c, [(M, hid), (M, C)], (float((got == x).float().mean()), M * C),
                               torch.equal(F_.fused_ffn_dropout(*args, 0.0, 0.0, DROP_SEED,
                                                                DROP_SITE, **kw),
                                           F_.fused_ffn(*fwd, **kw)), device)
                    judge_base(c, lambda b: F_.fused_ffn_dropout(*args, *drop, bases=b, **kw),
                               lambda b: F_.ffn_dropout_plain(*args, *drop, mxu_dtype=bf16,
                                                              bases=b, **kw))
                    timed(c, lambda: F_.fused_ffn_dropout(*args, *drop, **kw),
                          lambda: F_.ffn_dropout_plain(*args, *drop, mxu_dtype=bf16, **kw),
                          fw_bytes, device_time=True,
                          library_seq=ffn_library_seq(*fwd, *drop[:2], act=act),
                          bf16_flops=4 * M * C * hid)
                elif form == "ffn_dropout_bwd_full":
                    args = bwd + (1e-5,)
                    got = F_.fused_ffn_dropout_bwd_full(*args, *drop, **kw)
                    judge_all(c, names, got, F_.ffn_dropout_bwd_full_plain(
                        *args, *drop, mxu_dtype=bf16, **kw))
                    zero = F_.fused_ffn_dropout_bwd_full(*args, 0.0, 0.0, DROP_SEED, DROP_SITE,
                                                         **kw)
                    judge_drop(c, [(M, hid), (M, C)], None,
                               all(torch.equal(a, b) for a, b in
                                   zip(zero, F_.fused_ffn_bwd_full(*bwd, **kw))), device)
                    judge_base(c, lambda b: F_.fused_ffn_dropout_bwd_full(*args, *drop, bases=b,
                                                                          **kw),
                               lambda b: F_.ffn_dropout_bwd_full_plain(
                                   *args, *drop, mxu_dtype=bf16, bases=b, **kw), names)
                    timed(c, lambda: F_.fused_ffn_dropout_bwd_full(*args, *drop, **kw),
                          lambda: F_.ffn_dropout_bwd_full_plain(*args, *drop, mxu_dtype=bf16,
                                                                **kw),
                          bw_bytes, device_time=True, bf16_flops=10 * M * C * hid)
                    yardstick(c, ffn_library_bwd(*bwd, *drop, act=act))
                elif form == "ffn_bf16":
                    got, want = F_.fused_ffn(*fwd, **kw), F_.ffn_plain(*fwd, mxu_dtype=bf16, **kw)
                    judge_bf16(c, got, want, tol=2e-2)
                    timed(c, lambda: F_.fused_ffn(*fwd, **kw),
                          lambda: F_.ffn_plain(*fwd, mxu_dtype=bf16, **kw),
                          2 * (2 * M * C + 2 * C * hid + hid + 3 * C), device_time=True,
                          library_seq=ffn_library_seq(*fwd, act=act), bf16_flops=4 * M * C * hid)
                else:
                    got = F_.fused_ffn_bwd_dx(*bwd, **kw)
                    judge_bf16(c, got, F_.ffn_bwd_dx_plain(*bwd, mxu_dtype=bf16, **kw))
                    timed(c, lambda: F_.fused_ffn_bwd_dx(*bwd, **kw),
                          lambda: F_.ffn_bwd_dx_plain(*bwd, mxu_dtype=bf16, **kw),
                          2 * (3 * M * C + 2 * C * hid + hid + 2 * C), device_time=True,
                          bf16_flops=6 * M * C * hid)
                # the GELU form on the same inputs, timed after it: the activation's cost
                gelu = {"ffn": lambda: F_.fused_ffn(*fwd), "ffn_bf16": lambda: F_.fused_ffn(*fwd),
                        "ffn_bwd_dx": lambda: F_.fused_ffn_bwd_dx(*bwd),
                        "ffn_bwd_dx_bf16": lambda: F_.fused_ffn_bwd_dx(*bwd),
                        "ffn_bwd_full": lambda: F_.fused_ffn_bwd_full(*bwd),
                        "ffn_dropout": lambda: F_.fused_ffn_dropout(*fwd, 1e-5, *drop),
                        "ffn_dropout_bwd_full": lambda: F_.fused_ffn_dropout_bwd_full(
                            *bwd, 1e-5, *drop)}[form]
                c["gelu_device_ms"] = graph_time_ms(gelu)
                c["vs_gelu_device"] = c["device_ms"] / c["gelu_device_ms"]
                name = (f"{form[:-5]}_{act}_bf16" if form.endswith("_bf16")
                        else f"{form}_{act}")
                cases.setdefault(name, []).append(c)
    return cases


class CallRecorder:
    """Every call of the models' time blocks, attention layers and FFNs
    (forward pre-hooks) while it is entered: (module, input shape, training)."""

    def __init__(self, *models):
        self.models, self.calls, self.handles = models, [], []

    def __enter__(self):
        from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
        from prediff_torch.models.layers import PositionwiseFFN, TimeEmbedResBlock

        kinds = (TimeEmbedResBlock, CuboidSelfAttentionLayer, PositionwiseFFN)
        for model in self.models:
            for m in model.modules():
                if isinstance(m, kinds):
                    self.handles.append(m.register_forward_pre_hook(
                        lambda mod, args: self.calls.append(
                            (mod, tuple(args[0].shape), mod.training))))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()


def expected_from_calls(calls, backward):
    """The kernels' launches of the recorded calls, from each module's own
    route rules: ``backward`` None (a forward), "dx" (the input gradient:
    frozen parameters), "full" (every gradient).  A training call with a rate
    above 0 takes the dropout forms; a GN backward is the all-gradients one;
    a grouped core has no backward kernel."""
    from collections import Counter

    from prediff_torch.models.cuboid_attention import CuboidSelfAttentionLayer
    from prediff_torch.models.layers import PositionwiseFFN
    from prediff_torch.ops import ffn as ffn_ops, groupnorm as gn_ops, resblock as rb_ops

    n = Counter({k: 0 for k in list(KERNELS) + list(act_counts())})

    def gn():
        n["groupnorm_silu"] += 1
        n["groupnorm_silu_bwd_full"] += backward is not None

    for mod, shape, training in calls:
        C = shape[-1]
        if isinstance(mod, PositionwiseFFN):
            M = 1
            for s in shape[:-1]:
                M *= s
            if not (mod.kernel and ffn_ops.supports_shape(M, C, mod.ffn_1.out_features)):
                continue
            drop = training and (mod.activation_dropout > 0 or mod.dropout > 0)
            names = ["ffn_dropout" if drop else "ffn"]
            if backward is not None:
                names.append("ffn_dropout_bwd_full" if drop else
                             "ffn_bwd_full" if backward == "full" else "ffn_bwd_dx")
            for name in names:
                n[name] += 1
                if mod.activation != "gelu":
                    n[f"{name}_{mod.activation}"] += 1
        elif isinstance(mod, CuboidSelfAttentionLayer):
            route = mod.route(shape)
            if route in ("grouped", "grouped_masked"):
                n["cuboid_attention_grouped"] += 1
            elif route in ("axial", "v4"):
                base = "axial_attention" if route == "axial" else "cuboid_attention"
                drop = training and (mod.attn_drop > 0 or mod.proj_drop > 0)
                n[base + ("_dropout" if drop else "")] += 1
                if backward is not None:
                    n[base + ("_dropout_bwd_full" if drop else
                              "_bwd_full" if backward == "full" else "_bwd_dx")] += 1
        else:   # a time block
            if mod.fused and rb_ops.supports(C, mod.in_groups):
                n["resblock"] += 1
                n["resblock_bwd"] += backward is not None
                continue
            if mod.gn_kernel and gn_ops.supports(C, mod.in_groups):
                gn()
            out = mod.out_layers[0]
            if not mod.scale_shift and mod.gn_kernel and gn_ops.supports(out.num_channels,
                                                                         out.num_groups):
                gn()
    return dict(n)


def variant_models(cfg, vae_sd, latent, align, depth1=False, seed=SEED):
    """The randomized CPU models of ``cfg`` with ``latent`` / ``align``'s
    variant settings (cut to depth [1,1] with ``depth1``): (cfg, weights)."""
    import torch
    from prediff_torch.factory import build_alignment_model, build_unet
    from prediff_torch.models.init import init_params_

    if depth1:
        latent = None if latent is None else dict(latent, depth=[1, 1])
        align = None if align is None else dict(align, depth=[1, 1])
    c = variant_config(cfg, latent, align)
    gen = torch.Generator().manual_seed(seed)
    weights = {"vae": vae_sd}
    if latent is not None:
        weights["unet"] = init_params_(build_unet(c), gen, randomize=True).state_dict()
    if align is not None:
        weights["align"] = init_params_(build_alignment_model(c), gen,
                                        randomize=True).state_dict()
    return c, weights


def per_step_launches(predictor, cfg, guided, device):
    """The launches of one reverse step of ``predictor`` (a UNet forward at
    B=1, and with ``guided`` a guidance shift) from the modules' routes
    (``expected_from_calls`` over the calls of one eager step)."""
    import torch

    d = cfg.model.diffusion
    ld = predictor.ld
    z = torch.randn((1,) + tuple(d.latent_shape), device=device)
    zc = torch.randn((1,) + tuple(d.latent_cond_shape), device=device)
    t = torch.tensor([500], device=device)
    with CallRecorder(ld.unet) as rec, torch.no_grad():
        ld.unet(z, t, zc)
    per = expected_from_calls(rec.calls, None)
    if guided:
        with CallRecorder(ld.alignment.model) as rec:
            ld.alignment.get_mean_shift(z, t, torch.tensor([[AVG_X_GT]], device=device))
        for k, v in expected_from_calls(rec.calls, "dx").items():
            per[k] += v
    return per


def variant_forecasts(device, cfg, smi, vae_sd, zero_counts, read_counts):
    """``variant_guided_forecast`` (variant_kernels' UNet, variant_align's
    net, ``VARIANT_STEPS`` guided DDPM steps) and ``variant_globals_forecast``
    (variant_globals' UNet, unguided) through ``PreDiffPredictor.predict``,
    each eager and on graphs (``run_chains``: bit-equal, exact launches of
    every kernel and of each FFN activation in both runs).  Returns the
    launches by phase."""
    import torch
    from prediff_torch.serving import PreDiffPredictor

    def reads():
        return {**read_counts(), **act_counts()}

    img = cfg.layout
    rs = torch.Generator().manual_seed(SEED + 23)
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    out = {}
    for phase, latent, align in (
            ("variant_guided_forecast", VARIANT_UNETS["variant_kernels"],
             VARIANT_ALIGNS["variant_align"]),
            ("variant_globals_forecast", VARIANT_UNETS["variant_globals"], None)):
        c, weights = variant_models(cfg, vae_sd, latent, align)
        guided = align is not None
        predictor = PreDiffPredictor(c, params=weights, with_alignment=guided, device=device)
        per = per_step_launches(predictor, c, guided, device)
        kw = dict(timesteps=VARIANT_STEPS)
        if guided:
            kw.update(use_alignment=True, avg_x_gt=torch.tensor([[AVG_X_GT]]).numpy())
        out.update(run_chains(predictor, context, {phase: (kw, VARIANT_STEPS, guided)},
                              expect_shape, lambda steps, g: {k: steps * v for k, v in per.items()},
                              device, smi, zero_counts, reads))
        del predictor
    return out


def variant_vs_cpu(device, cfg, vae_sd, zero_counts, read_counts):
    """Depth-[1,1] copies of the variant UNets and alignment nets, every leaf
    randomized: the forward (bar of the forward phases), the gradient of
    every parameter and of the input for one cotangent (all gradients: the
    kernels' all-gradients forms) and the input gradient on frozen
    parameters (the dx forms), card against CPU with ``train_grads``' bars,
    at B=1 in eval mode; the launches from the modules' routes.  Returns the
    phase's launches."""
    import torch
    from prediff_torch.factory import build_alignment_model, build_unet

    d = cfg.model.diffusion
    rs = torch.Generator().manual_seed(SEED + 24)
    total = {}
    models = [(k, "unet", v) for k, v in VARIANT_UNETS.items()]
    models += [(k, "align", v) for k, v in VARIANT_ALIGNS.items()]
    for name, kind, over in models:
        c, weights = variant_models(cfg, vae_sd, over if kind == "unet" else None,
                                    over if kind == "align" else None, depth1=True)
        build = build_unet if kind == "unet" else build_alignment_model
        cpu = build(c)
        cpu.load_state_dict(weights[kind])
        card = build(c).to(device)
        card.load_state_dict(weights[kind])
        cpu.eval(), card.eval()
        if kind == "unet":
            x = torch.randn((1,) + tuple(d.latent_shape), generator=rs)
            extra = (torch.tensor([500]), torch.randn((1,) + tuple(d.latent_cond_shape),
                                                      generator=rs))
        else:
            x = torch.randn((1,) + tuple(c.model.align.model_args.input_shape), generator=rs)
            extra = (torch.tensor([500]),)

        def run(model, dev, params):
            model.requires_grad_(params)
            xi = x.to(dev).requires_grad_(True)
            out = model(xi, *(e.to(dev) for e in extra))
            g = torch.ones_like(out) / out.numel() ** 0.5
            leaves = [xi] + (list(model.parameters()) if params else [])
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
            return out.detach().cpu(), [torch.zeros_like(p) if gr is None else gr.cpu()
                                        for p, gr in zip(leaves, grads)]

        t1 = time.perf_counter()
        out_cpu, grads_cpu = run(cpu, "cpu", True)
        cpu_s = time.perf_counter() - t1
        run(card, device, True)   # warm-up: cuDNN's algorithms for these shapes
        sync(device)
        zero_counts()
        with CallRecorder(card) as rec:
            out_card, grads_card = run(card, device, True)
        sync(device)
        counts = {**read_counts(), **act_counts()}
        want = expected_from_calls(rec.calls, "full")
        zero_counts()
        with CallRecorder(card) as rec:
            _, dx_card = run(card, device, False)
        sync(device)
        counts_dx = {**read_counts(), **act_counts()}
        want_dx = expected_from_calls(rec.calls, "dx")
        fwd_rel = float((out_card - out_cpu).norm() / out_cpu.norm())
        rel_l2, cosine = rel_l2_and_cosine(grads_card, grads_cpu)
        dx_rel, dx_cos = rel_l2_and_cosine(dx_card, grads_cpu[:1])
        line = {"phase": "variant_vs_cpu", "model": name, "settings": over, "depth": [1, 1],
                "shape": list(out_card.shape), "forward_rel_l2_err": fwd_rel,
                "grad_rel_l2_err": rel_l2, "grad_cosine": cosine, "dx_rel_l2_err": dx_rel,
                "dx_cosine": dx_cos, "leaves": len(grads_card), "tol_forward_rel_l2": 2e-2,
                "tol_rel_l2": GRAD_TOL_REL_L2, "min_cosine": GRAD_MIN_COSINE,
                "launches": {k: v for k, v in counts.items() if v},
                "launches_dx": {k: v for k, v in counts_dx.items() if v},
                "cpu_forward_and_backward_s": cpu_s}
        emit(line)
        if (not torch.isfinite(out_card).all() or fwd_rel > 2e-2 or rel_l2 > GRAD_TOL_REL_L2
                or cosine < GRAD_MIN_COSINE or dx_rel > GRAD_TOL_REL_L2
                or dx_cos < GRAD_MIN_COSINE):
            fail(f"variant_vs_cpu ({name}): card differs from the CPU: {line}")
        if counts != want or counts_dx != want_dx:
            fail(f"variant_vs_cpu ({name}): launches {counts} / {counts_dx} != expected "
                 f"{want} / {want_dx}")
        for k in counts:
            total[k] = total.get(k, 0) + counts[k] + counts_dx[k]
        del cpu, card
    return total


def variant_train(device, cfg, smi, vae_sd, zero_counts, read_counts):
    """One ``DiffusionTrainer`` micro-step on variant_kernels and on
    variant_globals and one ``AlignmentTrainer`` micro-step on variant_align,
    depth [1,1] at v1's widths and the recipes' dropout rates: the dropout
    kernels on leaky and silu, exact launches (the modules' routes over the
    step's calls), a finite loss, parameters that move.  Returns the
    launches of the three steps."""
    import torch
    from prediff_torch.config import alignment_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_alignment_trainer, build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    total = {}
    steps = [("variant_kernels", cfg, VARIANT_UNETS["variant_kernels"], None),
             ("variant_globals", cfg, VARIANT_UNETS["variant_globals"], None),
             ("variant_align", alignment_default_config(), None, VARIANT_ALIGNS["variant_align"])]
    for name, base, latent, align in steps:
        c, weights = variant_models(base, vae_sd, latent, align, depth1=True)
        L = c.layout
        B = c.optim.micro_batch_size
        batch = torch.from_numpy(next(synthetic_batch_iterator(
            B, L.in_len + L.out_len, L.img_height, L.img_width, seed=SEED)))
        x, y = batch[:, L.in_len:].to(device), batch[:, :L.in_len].to(device)
        if latent is not None:
            trainer = DiffusionTrainer(build_training_pipeline(c, device=device, params=weights),
                                       optim_config=dict(lr=1e-3, total_num_steps=10))
            model = trainer.ld.unet
        else:
            trainer = build_alignment_trainer(c, device=device, params={"align": weights["align"]})
            model = trainer.model
        state = trainer.create_state()
        before = [p.detach().clone() for p in state.params.values()]
        sync(device)
        zero_counts()
        t1 = time.perf_counter()
        with CallRecorder(model) as rec:
            state, metrics = trainer.train_step(state, SEED, x, y)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t1)
        counts = {**read_counts(), **act_counts()}
        want = expected_from_calls(rec.calls, "full")
        loss = float(next(v for k, v in metrics.items() if "loss" in k))
        moved = sum(not torch.equal(a, b) for a, b in zip(before, state.params.values()))
        rates = {k: model.dropout_rates[k] for k in model.dropout_rates}
        emit({"phase": "variant_train", "model": name, "batch": B, "depth": [1, 1],
              "dropout": rates, "loss": loss, "micro_step_ms": ms, "leaves_moved": moved,
              "leaves": len(before), "launches": {k: v for k, v in counts.items() if v},
              "expected_launches": {k: v for k, v in want.items() if v}, "card": smi})
        if not (loss == loss and abs(loss) < float("inf")) or moved == 0:
            fail(f"variant_train ({name}): loss {loss}, {moved} leaves moved")
        if counts != want:
            fail(f"variant_train ({name}): launches {counts} != expected {want}")
        for k in counts:
            total[k] = total.get(k, 0) + counts[k]
        del trainer, state
    return total


def variant_phases(device, cfg, smi, vae_sd, zero_counts, read_counts):
    """The model variants: ``ffn_activations``, the variant forecasts,
    ``variant_vs_cpu`` and ``variant_train``.  Returns (the activation
    entries' cases, the launches by phase)."""
    acases = check_activation_kernels(device)
    bad = [(k, c["shape"]) for k, cs in acases.items() for c in cs if not c["ok"]]
    emit({"phase": "ffn_activations", "cases": sum(len(v) for v in acases.values()),
          "failed": len(bad), "card": smi,
          "worst_rel_err": max(c["max_rel_err"] for cs in acases.values() for c in cs)})
    if bad:
        fail(f"an FFN activation form disagrees with its plain version: {bad}")
    launches = variant_forecasts(device, cfg, smi, vae_sd, zero_counts, read_counts)
    launches["variant_vs_cpu"] = variant_vs_cpu(device, cfg, vae_sd, zero_counts, read_counts)
    launches["variant_train"] = variant_train(device, cfg, smi, vae_sd, zero_counts,
                                              read_counts)
    for name, (_, _, path) in ACT_KERNELS.items():
        if path is not None and not launches[path].get(name):
            fail(f"{name}: no launch on its path {path}")
    return acases, launches


def ffn_gelu_times(device, smi):
    """``--only ffn_gelu``: the device time of each GELU form of the FFN
    kernels (rows 2, 6, 12, 15a, 15b and the bf16 forms of 2 and 6) at the
    UNet's shapes (B=1 and the training micro-batch), by graph replay.  It
    calls the wrappers without the activation argument, as older trees
    take them, so a copy of this script in an older tree times that tree's
    kernels: compare two trees in one call, in turns."""
    import torch
    from prediff_torch.ops import ffn as F_

    gen = torch.Generator(device=device).manual_seed(SEED + 25)
    out = {}
    for M, C in VARIANT_FFN_SHAPES + ((6656, 256), (1664, 512)):
        hid = 4 * C
        x, g = (torch.randn(M, C, generator=gen, device=device) for _ in range(2))
        ln_w, ln_b = 1.0 + 0.1 * torch.randn(C, device=device), 0.1 * torch.randn(C, device=device)
        w1 = torch.randn(hid, C, generator=gen, device=device) * C ** -0.5
        w2 = torch.randn(C, hid, generator=gen, device=device) * hid ** -0.5
        b1, b2 = 0.1 * torch.randn(hid, device=device), 0.1 * torch.randn(C, device=device)
        fwd, bwd = (x, ln_w, ln_b, w1, b1, w2, b2), (x, g, ln_w, ln_b, w1, b1, w2)
        bf = [t.to(torch.bfloat16) for t in (x, g, w1, w2)]
        drop = (1e-5, DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
        forms = {"ffn": lambda: F_.fused_ffn(*fwd),
                 "ffn_bwd_dx": lambda: F_.fused_ffn_bwd_dx(*bwd),
                 "ffn_bwd_full": lambda: F_.fused_ffn_bwd_full(*bwd),
                 "ffn_dropout": lambda: F_.fused_ffn_dropout(*fwd, *drop),
                 "ffn_dropout_bwd_full": lambda: F_.fused_ffn_dropout_bwd_full(*bwd, *drop),
                 "ffn_bf16": lambda: F_.fused_ffn(bf[0], ln_w, ln_b, bf[2], b1, bf[3], b2),
                 "ffn_bwd_dx_bf16": lambda: F_.fused_ffn_bwd_dx(bf[0], bf[1], ln_w, ln_b, bf[2],
                                                                b1, bf[3])}
        for name, fn in forms.items():
            out.setdefault(name, {})[f"{M}x{C}"] = graph_time_ms(fn)
    emit({"phase": "ffn_gelu_times", "tree": os.getcwd(), "device_ms": out, "card": smi})


def dropout_times(device, smi):
    """``--only drop_times``: the device time of the dropout kernels with a
    host seed (rows 15a-15d and the general layer's forms, 15e) at the
    training micro-step's shapes, by graph replay.  It calls the wrappers as
    older trees take them, so a copy of this script in an older tree times
    that tree's kernels: compare two trees in one call, in turns."""
    import torch
    from prediff_torch.ops import attention as A_
    from prediff_torch.ops import ffn as F_

    gen = torch.Generator(device=device).manual_seed(SEED + 26)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    drop = (DROP_RATE, DROP_RATE, DROP_SEED, DROP_SITE)
    out, heads = {}, 4
    for M, C in ((6656, 256), (1664, 512)):
        hid = 4 * C
        x, g, ln_w, ln_b = randn(M, C), randn(M, C), randn(C, scale=0.1, shift=1.0), randn(C)
        w1, b1 = randn(hid, C, scale=C ** -0.5), randn(hid, scale=0.1)
        w2, b2 = randn(C, hid, scale=hid ** -0.5), randn(C, scale=0.1)
        forms = {"ffn_dropout": lambda: F_.fused_ffn_dropout(x, ln_w, ln_b, w1, b1, w2, b2,
                                                             1e-5, *drop),
                 "ffn_dropout_bwd_full": lambda: F_.fused_ffn_dropout_bwd_full(
                     x, g, ln_w, ln_b, w1, b1, w2, 1e-5, *drop)}
        for name, fn in forms.items():
            out.setdefault(name, {})[f"{M}x{C}"] = graph_time_ms(fn)
    for shape in ((2, 13, 16, 16, 256), (2, 13, 8, 8, 512)):
        C = shape[-1]
        for axis in range(3):
            vol = shape[1 + axis]
            x, g = randn(*shape), randn(*shape)
            w = (randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1),
                 randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
                 randn(C, C, scale=C ** -0.5))
            b_proj = randn(C, scale=0.1)
            forms = {"axial_attention_dropout": lambda: A_.fused_axial_attention_dropout(
                         x, axis, *w, b_proj, heads, (C // heads) ** -0.5, 1e-5, *drop),
                     "axial_attention_dropout_bwd_full":
                         lambda: A_.fused_axial_attention_dropout_bwd_full(
                             x, g, axis, *w, heads, (C // heads) ** -0.5, 1e-5, *drop)}
            for name, fn in forms.items():
                out.setdefault(name, {})[f"{shape}@{axis}"] = graph_time_ms(fn)
    for shape in ((2, 52, 64, 256), (2, 13, 64, 512)):
        C, vol = shape[-1], shape[2]
        x, g = randn(*shape), randn(*shape)
        w = (randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1), randn(3 * C, C, scale=C ** -0.5),
             randn(heads, vol, vol, scale=0.5), randn(C, C, scale=C ** -0.5))
        b_proj = randn(C, scale=0.1)
        forms = {"cuboid_attention_dropout": lambda: A_.fused_cuboid_attention_layer_dropout(
                     x, *w, b_proj, heads, (C // heads) ** -0.5, 1e-5, *drop),
                 "cuboid_attention_dropout_bwd_full":
                     lambda: A_.fused_cuboid_attention_layer_dropout_bwd_full(
                         x, g, *w, heads, (C // heads) ** -0.5, 1e-5, *drop)}
        for name, fn in forms.items():
            out.setdefault(name, {})[str(shape)] = graph_time_ms(fn)
    emit({"phase": "dropout_times", "tree": os.getcwd(), "device_ms": out, "card": smi})


def variants_alone(device, smi):
    """``--only variants``: the variant phases with the seeded randomized VAE,
    then their kernels line."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_vae
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    vae = init_params_(build_vae(cfg), torch.Generator().manual_seed(SEED), randomize=True)
    acases, launches = variant_phases(device, cfg, smi, vae.state_dict(), *kernel_counters())
    emit({"kernels": summarize(acases, launches)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write every JSON line to this file")
    ap.add_argument("--only", type=lambda v: v.split(","),
                    help="comma-separated phases to run alone (after the device line and the "
                         f"build), then stop: {', '.join(ONLY)}")
    ap.add_argument("--mesh-child", nargs=2, metavar=("ROOT", "RANK"),
                    help="run one rank of the mesh_* phases (started by them, not by hand)")
    ap.add_argument("--ddp-child", nargs=2, metavar=("ROOT", "RANK"),
                    help="run one rank of the ddp_* phases (started by them, not by hand)")
    ap.add_argument("--scan-child", nargs=2, metavar=("ROOT", "RANK"),
                    help="run one rank of the scan_mesh phases (started by them, not by hand)")
    args = ap.parse_args()
    if args.mesh_child:
        return mesh_child(args.mesh_child[0], int(args.mesh_child[1]))
    if args.ddp_child:
        return ddp_child(args.ddp_child[0], int(args.ddp_child[1]))
    if args.scan_child:
        return scan_child(args.scan_child[0], int(args.scan_child[1]))
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        from prediff_torch.config import prediff_default_config
        from prediff_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    if args.only:
        unknown = sorted(set(args.only) - set(ONLY))
        if unknown:
            print(f"chip_smoke: --only takes {', '.join(ONLY)}; not {unknown}", file=sys.stderr)
            return 2
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG.append(open(args.log, "w"))
    # the kernels build in a thread of their own while the phases that need
    # none of them, or the GN kernels alone, run (``run``); ffn_gelu builds the
    # FFN source alone, at its first launch
    build = None if args.only == ["ffn_gelu"] else Build(_build.build_all)
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
    if build is None:
        ffn_gelu_times(device, smi)
        print(smi, flush=True)
        return 0
    if args.only:
        build.wait()
        run_only(device, args.only, smi)
        print(smi, flush=True)
        return 0
    try:
        run(device, prediff_default_config(), smi, build)
    finally:   # a failed phase leaves no nvcc behind
        _build.stop_builds()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


class Build:
    """``build_all`` in a thread of its own, started at once; ``wait`` joins
    it, emits the ``build`` line (each source's nvcc seconds, ptxas's report,
    the phases that ran meanwhile) and raises what the build raised."""

    def __init__(self, build_all):
        import threading

        self.t0, self.report, self.error = time.perf_counter(), None, None
        self.thread = threading.Thread(target=self._run, args=(build_all,), daemon=True)
        self.thread.start()

    def _run(self, build_all):
        try:
            self.report = build_all()
        except BaseException as e:   # re-raised in wait
            self.error = e
        self.seconds = time.perf_counter() - self.t0

    def wait(self, meanwhile=()):
        t_call = time.perf_counter() - self.t0
        self.thread.join()
        if self.error is not None:
            raise self.error
        emit({"phase": "build", "seconds": self.seconds,
              "waited_s": max(0.0, self.seconds - t_call), "meanwhile": list(meanwhile),
              "per_source_seconds": {k: v["seconds"] for k, v in self.report.items()},
              "ptxas": {k: ptxas_by_function(v["ptxas"]) for k, v in self.report.items()}})


COUNTERS = {}   # kernel name -> its wrapper (kernel_counters)


def counters_zero():
    """Every wrapper's launch counts, its bf16 form's and the FFN
    activations' too, set to 0."""
    for fn in COUNTERS.values():
        fn.launches = 0
        for attr in ("bf16_launches",) + tuple(f"{a}_launches" for a in VARIANT_ACTS):
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def counters_read():
    return {k: fn.launches for k, fn in COUNTERS.items()}


def kernel_counters():
    """``(zero_counts, read_counts)`` over every kernel wrapper's launch count
    (``read_counts`` counts every form; ``bf16_counts`` the bf16 forms)."""
    from prediff_torch.ops.attention import fused_cuboid_attention, fused_cuboid_attention_layer_v3
    from prediff_torch.ops.attention import (fused_axial_attention, fused_axial_attention_bwd_dx,
                                             fused_axial_attention_bwd_full,
                                             fused_axial_attention_dropout,
                                             fused_axial_attention_dropout_bwd_full,
                                             fused_cuboid_attention_grouped,
                                             fused_cuboid_attention_layer,
                                             fused_cuboid_attention_layer_bwd_dx,
                                             fused_cuboid_attention_layer_bwd_full,
                                             fused_cuboid_attention_layer_dropout,
                                             fused_cuboid_attention_layer_dropout_bwd_full)
    from prediff_torch.ops.conv3d import conv3x3x3_dx, conv3x3x3_forward
    from prediff_torch.ops.ffn import (fused_ffn, fused_ffn_bwd_dx, fused_ffn_bwd_full,
                                       fused_ffn_dropout, fused_ffn_dropout_bwd_full)
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu, fused_groupnorm_silu_bwd_full
    from prediff_torch.ops.resblock import fused_resblock_bwd, fused_resblock_fwd

    counters = {"groupnorm_silu": fused_groupnorm_silu, "ffn": fused_ffn,
                "axial_attention": fused_axial_attention, "ffn_bwd_dx": fused_ffn_bwd_dx,
                "axial_attention_bwd_dx": fused_axial_attention_bwd_dx,
                "resblock": fused_resblock_fwd, "resblock_bwd": fused_resblock_bwd,
                "ffn_bwd_full": fused_ffn_bwd_full,
                "axial_attention_bwd_full": fused_axial_attention_bwd_full,
                "groupnorm_silu_bwd_full": fused_groupnorm_silu_bwd_full,
                "ffn_dropout": fused_ffn_dropout,
                "ffn_dropout_bwd_full": fused_ffn_dropout_bwd_full,
                "axial_attention_dropout": fused_axial_attention_dropout,
                "axial_attention_dropout_bwd_full": fused_axial_attention_dropout_bwd_full,
                "cuboid_attention": fused_cuboid_attention_layer,
                "cuboid_attention_bwd_dx": fused_cuboid_attention_layer_bwd_dx,
                "cuboid_attention_grouped": fused_cuboid_attention_grouped,
                "cuboid_attention_bwd_full": fused_cuboid_attention_layer_bwd_full,
                "cuboid_attention_dropout": fused_cuboid_attention_layer_dropout,
                "cuboid_attention_dropout_bwd_full": fused_cuboid_attention_layer_dropout_bwd_full,
                "conv3x3x3": conv3x3x3_forward, "conv3x3x3_dx": conv3x3x3_dx,
                "cuboid_core": fused_cuboid_attention,
                "cuboid_layer_v3": fused_cuboid_attention_layer_v3}

    COUNTERS.update(counters)
    return counters_zero, counters_read


# the phases --only runs alone: bwd_split (each launch's share of the
# all-gradients backwards, the general layer's dx and the resblock), guided_repeat,
# vae_train (with vae_train_grads), align_train (with align_train_grads), bf16
# (bf16_phases with the f32 chains beside them), vae_train_bf16 (with its grads),
# bf16params (bf16params_phases with the f32 chains beside them),
# eval (eval_suite), data (data_prefetch), cli (the cli_* phases), mesh
# (the mesh_* phases), ddp (the ddp_* phases), variants (the model variants:
# ffn_activations, the variant forecasts, variant_vs_cpu, variant_train), optins
# (profiling_helpers, optin_remat, optin_bf16_state), ffn_gelu (the FFN
# kernels' GELU forms' device times, alone), scan (scan_mesh, devseed_kernels_vs_plain,
# train_scan, scan_optins: steps_per_call on captured graphs) and drop_times (the dropout
# kernels' device times, to compare two trees)
ONLY = ("bwd_split", "guided_repeat", "vae_train", "align_train", "bf16", "vae_train_bf16",
        "bf16params", "eval", "data", "cli", "mesh", "ddp", "variants", "optins", "ffn_gelu",
        "scan", "drop_times")


def run_only(device, names, smi: str) -> None:
    from prediff_torch.config import alignment_default_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet
    from prediff_torch.utils.device import set_numerics

    set_numerics()
    if "eval" in names or "data" in names:
        eval_data_alone(device, smi, names)
    for name in names:
        if name in ("eval", "data"):
            continue
        if name == "cli":
            cli_alone(device, smi)
        elif name == "mesh":
            mesh_alone(device, smi)
        elif name == "ddp":
            ddp_alone(device, smi)
        elif name == "variants":
            variants_alone(device, smi)
        elif name == "optins":
            optins_alone(device, smi)
        elif name == "scan":
            scan_alone(device, smi)
        elif name == "drop_times":
            dropout_times(device, smi)
        elif name == "bwd_split":
            bwd_split(device)
        elif name == "guided_repeat":
            guided_repeat(device)
        elif name == "vae_train":
            vae_train_phases(device, smi)
        elif name == "vae_train_bf16":
            vae_train_bf16_phases(device, smi)
        elif name == "bf16":
            bf16_alone(device, smi)
        elif name == "bf16params":
            bf16params_alone(device, smi)
        else:
            cfg = alignment_default_config()
            per = path_launches(build_unet(prediff_default_config()), build_alignment_model(cfg),
                                cfg.optim.micro_batch_size)
            align_train_phases(device, smi, per, *kernel_counters())


def run(device, cfg, smi: str, build) -> None:
    """Every phase on ``device``, the first while ``build`` (``Build``) runs:
    the tiny phases and ``cli_learning_check`` (the configuration's widths
    take no kernel but GN's, whose first launch waits for its source), the
    randomized models and the kernel cases on the CPU; raises SystemExit on a
    failed check."""
    import torch
    from prediff_torch.config import alignment_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.device import set_numerics

    set_numerics()
    zero_counts, read_counts = kernel_counters()
    tiny_phases(device, zero_counts, read_counts)
    launches_early = cli_phases(device, smi, None, None, zero_counts, read_counts,
                                names=("cli_learning_check",))
    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    align_cpu = init_params_(build_alignment_model(cfg), gen,
                             randomize=True).eval().requires_grad_(False)
    emit({"phase": "weights", "randomized": True, "seed": SEED,
          "unet_params": sum(p.numel() for p in unet_cpu.parameters()),
          "vae_params": sum(p.numel() for p in vae_cpu.parameters()),
          "align_params": sum(p.numel() for p in align_cpu.parameters())})

    cases = kernel_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size,
                         alignment_default_config().optim.micro_batch_size)
    build.wait(meanwhile=["tiny_forecast", "tiny_guided_shift", "tiny_train",
                          "cli_learning_check", "weights", "kernel cases"])
    bad = check_kernels(cases, device)
    emit({"phase": "kernels_vs_plain", "cases": sum(len(v) for v in cases.values()),
          "failed": len(bad)})
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    bwd_split(device)
    # the conv route's kernels at every shape of its path, and the round-1 ops
    cases.update(conv_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size))
    bad = check_conv_kernels(cases, device)
    emit({"phase": "conv_kernels_vs_plain", "cases": sum(len(cases[k]) for k in CONV_KERNELS),
          "failed": len(bad), "tol_rel": CONV_TOL_REL,
          "worst_rel_err": max(c["max_rel_err"] for k in CONV_KERNELS for c in cases[k])})
    if bad:
        fail(f"conv kernel disagrees with its plain version: {bad}")
    cases.update(round1_cases())
    bad = check_round1_kernels(cases, device)
    for name in ROUND1_KERNELS:
        emit({"phase": f"{name}_vs_plain", "cases": len(cases[name]),
              "failed": sum(n == name for n, _ in bad), "tol_rel": ROUND1_TOL_REL,
              "worst_rel_err": max(c["max_rel_err"] for c in cases[name])})
    if bad:
        fail(f"round-1 kernel disagrees with its plain version: {bad}")

    predictor = PreDiffPredictor(cfg, params={"unet": unet_cpu.state_dict(),
                                              "vae": vae_cpu.state_dict(),
                                              "align": align_cpu.state_dict()},
                                 with_alignment=True, device=device)

    kernel_switches(device, cfg, smi, zero_counts, read_counts)
    guided_repeat(device)

    # the launch counts of the other paths come from the layers' routes: on
    # the axial path they must give what the kernel cases give
    by_route = path_launches(unet_cpu, align_cpu)
    by_case = {k: {key: sum(c.get(key, 0) for c in cs)
                   for key in ("per_unet", "per_align", "per_train", "per_align_train")}
               for k, cs in cases.items()}
    if by_route != by_case:
        fail(f"launch counts by route {by_route} != by kernel case {by_case}")

    rs = torch.Generator().manual_seed(SEED + 1)
    d = cfg.model.diffusion
    x, t, cond = forward_vs_cpu("denoise_forward", unet_cpu, predictor, cfg, rs, device)
    want_counts = {k: sum(c["per_align"] for c in cs) for k, cs in cases.items()}
    avg = shift_vs_cpu("guided_shift", align_cpu, predictor, cfg, rs, t, want_counts, device,
                       zero_counts, read_counts)

    # The three chains: VAE encode, the steps, VAE decode.
    img = cfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    avg_x_gt = avg.numpy()
    chains = {
        "forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True, avg_x_gt=avg_x_gt),
                            CHAIN_STEPS, True),
        "ddim_forecast": (dict(ddim_steps=cfg.eval.val_ddim_steps, use_alignment=True,
                               avg_x_gt=avg_x_gt), cfg.eval.val_ddim_steps, True),
    }
    launches_by_path = run_chains(predictor, context, chains, expect_shape,
                                  lambda steps, guided: expected_launches(cases, steps, guided),
                                  device, smi, zero_counts, read_counts)

    xd, td, cd = x.to(device), t.to(device), cond.to(device)
    emit(profile("profile_unet_forward", lambda: predictor.ld.unet(xd, td, cd), reps=5))
    zc = predictor.ld.cond_stage_forward(context.to(device))
    zg = torch.randn((1,) + tuple(d.latent_shape), device=device)
    avg_d = avg.to(device)
    emit(profile("profile_guided_step",
                 guided_step(predictor.ld, zg, zc, avg_d),
                 reps=5))
    emit(profile("profile_guidance_shift",
                 lambda: predictor.ld.alignment.get_mean_shift(zg, td, avg_d), reps=5))
    emit(determinism_cost({
        "guided_step": guided_step(predictor.ld, zg, zc, avg_d),
        "unet_forward": lambda: predictor.ld.unet(xd, td, cd),
        "guidance_shift": lambda: predictor.ld.alignment.get_mean_shift(zg, td, avg_d)}))
    profiling_helpers(device, smi, cfg, predictor, by_route, avg_d, zero_counts, read_counts)
    graph_recapture(predictor, context, avg_x_gt, device)
    eval_suite(device, smi, predictor, cfg, zero_counts, read_counts)
    del predictor
    weights = {"unet": unet_cpu.state_dict(), "vae": vae_cpu.state_dict(),
               "align": align_cpu.state_dict()}
    data_prefetch(device, smi, cfg, {"unet": weights["unet"], "vae": weights["vae"]})
    bcases, bf16_launches = bf16_phases(device, cfg, smi, weights, cases, by_route, align_cpu)
    launches_by_path.update(bf16_launches)
    conv_launches, conv_per = conv_serving_phases(device, cfg, smi, weights, zero_counts,
                                                  read_counts)
    launches_by_path.update(conv_launches)
    swin_launches = swin_phases(device, cfg, smi, cases, zero_counts, read_counts)
    launches_by_path.update(swin_launches)
    pcases, bf16params_launches = bf16params_phases(device, cfg, smi, weights, cases, by_route)
    launches_by_path.update(bf16params_launches)
    for name, cs in pcases.items():   # rows 1-3 at the UNet's shapes join their bf16 rows
        bcases.setdefault(name, []).extend(cs)
    pattern_phases(device, cfg, zero_counts, read_counts)
    per_train = {k: v["per_train"] for k, v in by_route.items()}
    train_weights = {"unet": weights["unet"], "vae": weights["vae"]}
    launches_by_path.update(train_phases(device, cfg, smi, per_train, train_weights, zero_counts,
                                         read_counts, optins=True))
    # the conv route in training: the recipe's rates (no rate-0 phase), B=2
    launches_by_path.update(train_phases(
        device, conv_config(cfg), smi, {k: v["per_train"] for k, v in conv_per.items()},
        train_weights, zero_counts, read_counts, prefix="conv_", rate0=False, depth1=True))
    launches_by_path.update(swin_train_phases(device, cfg, smi, vae_cpu.state_dict(),
                                              zero_counts, read_counts))
    vae_train_phases(device, smi)
    vae_train_bf16_phases(device, smi)
    launches_by_path["align_train"] = align_train_phases(device, smi, by_route, zero_counts,
                                                         read_counts)
    acases, variant_launches = variant_phases(device, cfg, smi, vae_cpu.state_dict(),
                                              zero_counts, read_counts)
    launches_by_path.update(variant_launches)
    launches_by_path.update(launches_early)
    launches_by_path.update(cli_phases(device, smi, weights, by_route, zero_counts, read_counts,
                                       names=CLI_PHASES[:-1]))
    launches_by_path.update(mesh_phases(device, smi, cfg, weights, by_route))
    launches_by_path.update(ddp_phases(device, smi, cfg, weights, by_route))
    launches_by_path.update(scan_mesh_phases(device, smi, cfg, weights, by_route))
    # last: the captures of train_scan leave card memory reserved in this process, which
    # would shrink the mesh, DDP and scan_mesh children's shares and so their cuDNN
    # algorithms
    scases, scan_launches = scan_phases(device, smi, cfg, train_weights, by_route, cases,
                                        zero_counts, read_counts)
    launches_by_path.update(scan_launches)
    emit({"phase": "graph_chains", "card": smi, "chains": GRAPH_CHAINS})
    emit({"kernels": summarize({**cases, **bcases, **acases, **scases}, launches_by_path)})
    print(smi, flush=True)


def conv_config(cfg):
    """``cfg`` with the opt-in bf16 conv route in the UNet and the alignment net."""
    from prediff_torch.config import ConfigDict, deep_merge

    return ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"use_pallas_conv": True},
        "align": {"model_args": {"use_pallas_conv": True}}}}))


def conv_serving_phases(device, cfg, smi, weights, zero_counts, read_counts):
    """Forecasts on the conv route (``conv_config``), the same random weights:
    the route's launches from the models' blocks held to ``CONV_EXPECTED``, a
    UNet forward (with its exact counts) and a guidance shift card against CPU
    (the CPU takes the plain conv with the same bf16 rounding), the
    ``CHAIN_STEPS``-step unguided and guided DDPM forecasts with exact counts, profiles of a UNet
    forward and a guided step.  Returns the chains' launches and the route's
    ``path_launches``."""
    import torch
    from prediff_torch.factory import build_alignment_model, build_unet
    from prediff_torch.serving import PreDiffPredictor

    ccfg = conv_config(cfg)
    unet_cpu, align_cpu = build_unet(ccfg), build_alignment_model(ccfg)
    unet_cpu.load_state_dict(weights["unet"])
    align_cpu.load_state_dict(weights["align"])
    unet_cpu.eval().requires_grad_(False)
    align_cpu.eval().requires_grad_(False)
    per = path_launches(unet_cpu, align_cpu, ccfg.optim.micro_batch_size)
    routed = {k: per[k] for k in CONV_KERNELS}
    emit({"phase": "conv_routes", "launches_per_call": routed, "expected": CONV_EXPECTED})
    if routed != CONV_EXPECTED:
        fail(f"conv route: launches by route {routed} != expected {CONV_EXPECTED}")
    predictor = PreDiffPredictor(ccfg, params=weights, with_alignment=True, device=device)
    rs = torch.Generator().manual_seed(SEED + 1)
    zero_counts()
    x, t, cond = forward_vs_cpu("conv_denoise_forward", unet_cpu, predictor, ccfg, rs, device)
    counts, want = read_counts(), {k: v["per_unet"] for k, v in per.items()}
    emit({"phase": "conv_denoise_forward_launches", "launches": counts,
          "expected_launches": want})
    if counts != want:
        fail(f"conv route: forward launches {counts} != expected {want}")
    avg = shift_vs_cpu("conv_guided_shift", align_cpu, predictor, ccfg, rs, t,
                       {k: v["per_align"] for k, v in per.items()}, device, zero_counts,
                       read_counts)
    img = ccfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    chains = {
        "conv_forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "conv_guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                      avg_x_gt=avg.numpy()), CHAIN_STEPS, True),
    }

    def expected(steps, guided):
        return {k: steps * (v["per_unet"] + (v["per_align"] if guided else 0))
                for k, v in per.items()}

    launches = run_chains(predictor, context, chains, expect_shape, expected, device, smi,
                          zero_counts, read_counts)
    launches.update(conv_bf16_guidance_chain(predictor, context, per, avg, expect_shape, device,
                                             smi))
    xd, td, cd = x.to(device), t.to(device), cond.to(device)
    emit(profile("conv_profile_unet_forward", lambda: predictor.ld.unet(xd, td, cd), reps=5))
    zc = predictor.ld.cond_stage_forward(context.to(device))
    zg = torch.randn((1,) + tuple(ccfg.model.diffusion.latent_shape), device=device)
    avg_d = avg.to(device)
    emit(profile("conv_profile_guided_step",
                 guided_step(predictor.ld, zg, zc, avg_d),
                 reps=5))
    return launches, per


TINY_CONFIG = "configs/tiny_smoke.yaml"   # base_units 16: widths 16 and 32
TINY_FWD_TOL_REL_L2 = 2e-2                 # card vs CPU forecast (the UNet forward's bar)
TINY_RATE = 0.1                            # the recipe's rates for the tiny training step
# the kernels whose widths (C a multiple of 64; the resblock's too) the tiny
# configuration's layers do not reach: they must launch none there
TINY_REFUSED = tuple(k for k in KERNELS if k.startswith(("ffn", "axial_attention", "cuboid",
                                                         "resblock")))


# the configuration's use_pallas_* switches: the network section each is set in and the
# kernels a model built with it False must not launch
KERNEL_SWITCHES = (
    ("use_pallas_attention", "latent_model", ("axial_attention", "axial_attention_bwd_dx")),
    ("use_pallas_ffn", "latent_model", ("ffn", "ffn_bwd_dx")),
    ("use_pallas_gn", "latent_model", ("groupnorm_silu", "groupnorm_silu_bwd_full")),
    ("use_pallas_resblock", "align", ("resblock", "resblock_bwd")))


def kernel_switches(device, cfg, smi, zero_counts, read_counts):
    """``kernel_switches``: for each switch of ``KERNEL_SWITCHES`` a model
    built with it False and one built with it "auto" (the default; the UNet at
    the configuration's widths cut to depth [1,1], the alignment net of
    ``alignment_default_config`` for ``use_pallas_resblock``) run a forward
    and its input gradient on the card (frozen, as in guidance), the counts
    set to 0 just before and read just after: False launches none of the
    switch's kernels, "auto" launches each (the control)."""
    import torch
    from prediff_torch.config import ConfigDict, alignment_default_config, deep_merge
    from prediff_torch.factory import build_alignment_model, build_unet
    from prediff_torch.models.init import init_params_

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 61)
    acfg = alignment_default_config()
    out, failed = {}, []
    for key, section, kernels in KERNEL_SWITCHES:
        out[key] = {}
        for value in ("auto", False):
            if section == "latent_model":
                c = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"latent_model": {
                    "depth": [1, 1], key: value}}}))
                model, build = None, build_unet
                x = torch.randn((1,) + tuple(c.model.diffusion.latent_shape), generator=gen)
                cond = torch.randn((1,) + tuple(c.model.diffusion.latent_cond_shape),
                                   generator=gen).to(device)
                extra = (cond,)
            else:
                c = ConfigDict.wrap(deep_merge(acfg.to_dict(), {"model": {"align": {
                    "model_args": {key: value}}}}))
                build = build_alignment_model
                x = torch.randn((1,) + tuple(c.model.align.model_args.input_shape), generator=gen)
                extra = ()
            model = init_params_(build(c), torch.Generator().manual_seed(SEED)).to(device)
            model.eval().requires_grad_(False)
            x = x.to(device).requires_grad_(True)
            t = torch.full((1,), 3, device=device)
            zero_counts()
            torch.autograd.grad(model(x, t, *extra).square().sum(), x)
            sync(device)
            counts = read_counts()
            out[key][str(value)] = {k: counts[k] for k in kernels}
            if value is False and any(counts[k] for k in kernels):
                failed.append(f"{key}: False launched {out[key][str(value)]}")
            if value == "auto" and not all(counts[k] for k in kernels):
                failed.append(f"{key}: 'auto' did not launch every kernel of {kernels}")
            del model
    emit({"phase": "kernel_switches", "launches": out, "seconds": time.perf_counter() - t0,
          "failed": failed, "card": smi})
    if failed:
        fail(f"kernel_switches: {failed}")


def tiny_phases(device, zero_counts, read_counts):
    """``configs/tiny_smoke.yaml`` through the port's entry points on the
    card, random weights from the seed: each fused layer routes by shape, so
    the FFN, attention and resblock layers run their library ops (f32) and
    the GN kernels run where they take the width.  ``tiny_forecast``: an
    8-step DDPM forecast through ``PreDiffPredictor.predict`` (finite, of the
    output's shape) and the same chain from a fixed x_T at temperature 0
    card against CPU; ``tiny_guided_shift``: the guidance shift card against
    CPU; ``tiny_train``: at rates 0 and 0.1 one loss and backward at B=2
    card against CPU (the same draws and masks), then one
    ``DiffusionTrainer.train_step`` from ``build_training_pipeline``.  Each
    counts the kernels' launches: none of ``TINY_REFUSED``."""
    import numpy as np
    import torch
    from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import (build_alignment_model, build_training_pipeline,
                                       build_unet, build_vae)
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.training import DiffusionTrainer

    cfg = load_config(prediff_default_config,
                      os.path.join(os.path.dirname(os.path.abspath(__file__)), TINY_CONFIG))
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(cfg), gen, randomize=True).eval().requires_grad_(False)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    weights = {k: m.state_dict() for k, m in models.items()}
    routes = sorted({layer.route((1, *shape)) for m in (models["unet"], models["align"])
                     for shape, layer, _ in attention_layers(m, 1)})

    def check_counts(phase, counts, gn_expected=True):
        launched = {k: counts[k] for k in TINY_REFUSED if counts[k]}
        if launched:
            fail(f"{phase}: kernels launched at widths they refuse: {launched}")
        if gn_expected and not counts["groupnorm_silu"]:
            fail(f"{phase}: the GN kernel, which takes these widths, never launched")

    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device)
    cpu = PreDiffPredictor(cfg, params=weights, with_alignment=True, device="cpu")
    rs = torch.Generator().manual_seed(SEED + 3)
    L, d = cfg.layout, cfg.model.diffusion
    context = torch.rand((1, L.in_len, L.img_height, L.img_width, L.data_channels), generator=rs)
    x_T = torch.randn((1,) + tuple(d.latent_shape), generator=rs)
    steps = d.timesteps
    zero_counts()
    t1 = time.perf_counter()
    forecast = predictor.predict(context, timesteps=steps)
    sync(device)
    wall = time.perf_counter() - t1
    counts = read_counts()
    with torch.no_grad():
        card = predictor.ld.sample(context, x_T=x_T, temperature=0.0, timesteps=steps).cpu()
        ref = cpu.ld.sample(context, x_T=x_T, temperature=0.0, timesteps=steps)
    rel_l2 = float((card - ref).norm() / ref.norm())
    expect = (1, L.out_len, L.img_height, L.img_width, L.data_channels)
    emit({"phase": "tiny_forecast", "config": TINY_CONFIG, "steps": steps, "routes": routes,
          "shape": list(forecast.shape), "finite": bool(torch.isfinite(forecast).all()),
          "wall_s": wall, "rel_l2_err_temperature0": rel_l2, "tol_rel_l2": TINY_FWD_TOL_REL_L2,
          "launches": counts})
    if tuple(forecast.shape) != expect or not torch.isfinite(forecast).all():
        fail(f"tiny_forecast: forecast {tuple(forecast.shape)} (want {expect}) or not finite")
    if not torch.isfinite(card).all() or rel_l2 > TINY_FWD_TOL_REL_L2:
        fail(f"tiny_forecast: the card's chain differs from the CPU's: rel_l2 {rel_l2}")
    check_counts("tiny_forecast", counts)

    t = torch.tensor([steps // 2])
    avg = torch.tensor([[AVG_X_GT]])
    z = torch.randn((1,) + tuple(cfg.model.align.model_args.input_shape), generator=rs)
    shift_cpu = cpu.ld.alignment.get_mean_shift(z, t, avg)
    zero_counts()
    shift = predictor.ld.alignment.get_mean_shift(z.to(device), t.to(device),
                                                  avg.to(device)).cpu()
    sync(device)
    counts = read_counts()
    rel_l2 = float((shift - shift_cpu).norm() / shift_cpu.norm())
    cosine = float((shift * shift_cpu).sum() / (shift.norm() * shift_cpu.norm()))
    emit({"phase": "tiny_guided_shift", "rel_l2_err": rel_l2, "cosine": cosine,
          "tol_rel_l2": SHIFT_TOL_REL_L2, "min_cosine": SHIFT_MIN_COSINE, "launches": counts})
    if not torch.isfinite(shift).all() or rel_l2 > SHIFT_TOL_REL_L2 or cosine < SHIFT_MIN_COSINE:
        fail(f"tiny_guided_shift: card differs from the CPU: rel_l2 {rel_l2}, cosine {cosine}")
    check_counts("tiny_guided_shift", counts)
    del predictor, cpu

    B = cfg.optim.micro_batch_size
    z = torch.randn((B,) + tuple(d.latent_shape), generator=rs)
    zc = torch.randn((B,) + tuple(d.latent_cond_shape), generator=rs)
    tt = torch.randint(0, d.timesteps, (B,), generator=rs)
    noise = torch.randn(z.shape, generator=rs)
    logvar0 = 0.1 * torch.randn(d.timesteps, generator=rs)
    batch = torch.from_numpy(next(synthetic_batch_iterator(
        B, L.in_len + L.out_len, L.img_height, L.img_width, seed=SEED)))
    for rate in (0.0, TINY_RATE):
        c = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"latent_model": {
            k: rate for k in ("attn_drop", "proj_drop", "ffn_drop")}}}))
        out = {}
        for dev in ("cpu", device):
            ld = build_training_pipeline(c, device=dev, params=weights)
            logvar = logvar0.to(dev).requires_grad_(True)
            zero_counts()
            loss, _ = ld.p_losses(logvar, z.to(dev), zc.to(dev), tt.to(dev), noise.to(dev),
                                  dropout_seed=DROP_SEED)
            grads = torch.autograd.grad(loss, list(ld.unet.parameters()) + [logvar])
            sync(torch.device(dev))
            out[str(dev)] = (float(loss.detach()), [gr.detach().cpu().double().flatten()
                                                     for gr in grads], read_counts())
        (loss_cpu, g_cpu, _), (loss_card, g_card, counts) = out["cpu"], out[str(device)]
        diff = torch.cat([a - b for a, b in zip(g_card, g_cpu)])
        rel_l2 = float(diff.norm() / torch.cat(g_cpu).norm())
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        trainer = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=10))
        state = trainer.create_state()
        zero_counts()
        state, metrics = trainer.train_step(state, SEED, batch[:, L.in_len:].to(device),
                                            batch[:, :L.in_len].to(device))
        sync(device)
        step_counts = read_counts()
        step_loss = float(metrics["train/loss"])
        emit({"phase": "tiny_train", "rate": rate, "batch": B, "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_rel_err": loss_rel, "tol_loss_rel": LOSS_TOL_REL,
              "grad_rel_l2_err": rel_l2, "tol_rel_l2": GRAD_TOL_REL_L2, "launches": counts,
              "train_step_loss": step_loss, "train_step_launches": step_counts})
        if loss_rel > LOSS_TOL_REL or rel_l2 > GRAD_TOL_REL_L2:
            fail(f"tiny_train at rate {rate}: card differs from the CPU: loss {loss_rel}, "
                 f"gradient rel_l2 {rel_l2}")
        if not np.isfinite(step_loss):
            fail(f"tiny_train at rate {rate}: train_step's loss {step_loss}")
        check_counts(f"tiny_train at rate {rate}", counts)
        check_counts(f"tiny_train step at rate {rate}", step_counts)
        del ld, trainer, state


def swin_models(cfg):
    """``cfg`` with ``SWIN_PATTERN`` in the UNet and the alignment net, and
    its three models on the CPU, weights random from the seed."""
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_

    scfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"self_pattern": SWIN_PATTERN},
        "align": {"model_args": {"block_attn_patterns": SWIN_PATTERN}}}}))
    gen = torch.Generator().manual_seed(SEED)
    return scfg, {key: init_params_(build(scfg), gen, randomize=True).eval().requires_grad_(False)
                  for key, build in (("unet", build_unet), ("vae", build_vae),
                                     ("align", build_alignment_model))}


def swin_phases(device, cfg, smi, cases, zero_counts, read_counts):
    """The forecasts with the non-axial cuboid pattern ``SWIN_PATTERN`` in the
    UNet and the alignment net, everything else as ``cfg``, weights random
    from the seed: the three cuboid kernels against their plain versions
    (``swin_kernels_vs_plain``; their cases join ``cases``), a UNet forward
    and a guidance shift card against CPU, the ``CHAIN_STEPS``-step unguided and guided
    DDPM forecasts with exact launch counts, profiles of a UNet forward, a
    guided step and a guidance shift.  Returns the launches of the two chains."""
    import torch
    from prediff_torch.serving import PreDiffPredictor

    scfg, models = swin_models(cfg)
    unet_cpu, align_cpu = models["unet"], models["align"]
    cases.update(swin_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size))
    bad = check_cuboid_kernels(cases, device)
    routes = {name: [[layer.route((1, *shape)) for layer in blk.attn_l]
                     for shape, blk in zip(m.mem_shapes, [b[0] for b in m.down_self_blocks])]
              for name, m in (("unet", unet_cpu), ("align", align_cpu))}
    emit({"phase": "swin_kernels_vs_plain", "pattern": SWIN_PATTERN, "routes": routes,
          "cases": sum(len(cases[k]) for k in CUBOID_KERNELS), "failed": len(bad)})
    if bad:
        fail(f"cuboid kernel disagrees with its plain version: {bad}")

    per = path_launches(unet_cpu, align_cpu)
    predictor = PreDiffPredictor(scfg, params={k: m.state_dict() for k, m in models.items()},
                                 with_alignment=True, device=device)
    rs = torch.Generator().manual_seed(SEED + 1)
    x, t, cond = forward_vs_cpu("swin_denoise_forward", unet_cpu, predictor, scfg, rs, device)
    avg = shift_vs_cpu("swin_guided_shift", align_cpu, predictor, scfg, rs, t,
                       {k: v["per_align"] for k, v in per.items()}, device, zero_counts,
                       read_counts)
    img = scfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    chains = {
        "swin_forecast": (dict(timesteps=CHAIN_STEPS), CHAIN_STEPS, False),
        "swin_guided_forecast": (dict(timesteps=CHAIN_STEPS, use_alignment=True,
                                      avg_x_gt=avg.numpy()), CHAIN_STEPS, True),
    }

    def expected(steps, guided):
        return {k: steps * (v["per_unet"] + (v["per_align"] if guided else 0))
                for k, v in per.items()}

    launches = run_chains(predictor, context, chains, expect_shape, expected, device, smi,
                          zero_counts, read_counts)
    xd, td, cd = x.to(device), t.to(device), cond.to(device)
    emit(profile("swin_profile_unet_forward", lambda: predictor.ld.unet(xd, td, cd), reps=5))
    zc = predictor.ld.cond_stage_forward(context.to(device))
    zg = torch.randn((1,) + tuple(scfg.model.diffusion.latent_shape), device=device)
    avg_d = avg.to(device)
    emit(profile("swin_profile_guided_step",
                 guided_step(predictor.ld, zg, zc, avg_d),
                 reps=5))
    emit(profile("swin_profile_guidance_shift",
                 lambda: predictor.ld.alignment.get_mean_shift(zg, td, avg_d), reps=5))
    return launches


def swin_train_phases(device, cfg, smi, vae_sd, zero_counts, read_counts):
    """The training phases (``train_phases``) on ``SWIN_PATTERN`` in the UNet,
    each on a randomized UNet cut to depth [1,1] (``vae_sd`` the VAE's
    weights): ``swin_train_rate0``, ``swin_train_grads``, ``swin_train`` and
    ``profile_swin_train_step``.  Returns the launches of the rate-0
    optimizer step and of the ``fit`` run."""
    from prediff_torch.config import ConfigDict, deep_merge

    scfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"self_pattern": SWIN_PATTERN}}}))
    return train_phases(device, scfg, smi, None, {"vae": vae_sd}, zero_counts, read_counts,
                        prefix="swin_", depth1=True)


def pattern_phases(device, cfg, zero_counts, read_counts):
    """For each of ``PATTERN_CHECKS``, at full width with the UNet cut to
    depth [1,1] and random weights from the seed: a UNet forward and a
    guidance shift card against CPU, each with its exact launch counts."""
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    for pattern in PATTERN_CHECKS:
        pcfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
            "latent_model": {"self_pattern": pattern, "depth": [1, 1]},
            "align": {"model_args": {"block_attn_patterns": pattern}}}}))
        gen = torch.Generator().manual_seed(SEED)
        models = {key: init_params_(build(pcfg), gen, randomize=True).eval().requires_grad_(False)
                  for key, build in (("unet", build_unet), ("vae", build_vae),
                                     ("align", build_alignment_model))}
        per = path_launches(models["unet"], models["align"])
        predictor = PreDiffPredictor(pcfg, params={k: m.state_dict() for k, m in models.items()},
                                     with_alignment=True, device=device)
        rs = torch.Generator().manual_seed(SEED + 1)
        zero_counts()
        _, t, _ = forward_vs_cpu(f"pattern_{pattern}_forward", models["unet"], predictor, pcfg,
                                 rs, device)
        counts, want = read_counts(), {k: v["per_unet"] for k, v in per.items()}
        routes = [[layer.route((1, *shape)) for layer in blk[0].attn_l]
                  for shape, blk in zip(models["unet"].mem_shapes,
                                        models["unet"].down_self_blocks)]
        emit({"phase": f"pattern_{pattern}_forward_launches", "routes": routes,
              "launches": counts, "expected_launches": want})
        if counts != want:
            fail(f"pattern {pattern}: forward launches {counts} != expected {want}")
        shift_vs_cpu(f"pattern_{pattern}_shift", models["align"], predictor, pcfg, rs, t,
                     {k: v["per_align"] for k, v in per.items()}, device, zero_counts,
                     read_counts)
        del predictor, models


def depth1_unet(cfg, vae_sd, **latent):
    """``cfg`` with its UNet cut to depth [1,1] (and ``latent``'s settings of
    it), a randomized UNet of that configuration from the seed with
    ``vae_sd`` as the training pipeline's weights, and the UNet's launches per
    training micro-step (``path_launches``)."""
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_unet
    from prediff_torch.models.init import init_params_

    cfg1 = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"latent_model": dict(
        depth=[1, 1], **latent)}}))
    unet = init_params_(build_unet(cfg1), torch.Generator().manual_seed(SEED),
                        randomize=True).eval()   # the routes path_launches reads
    per = {k: v["per_train"]
           for k, v in path_launches(unet, train_batch=cfg.optim.micro_batch_size).items()}
    return cfg1, {"unet": unet.state_dict(), "vae": vae_sd}, per


def rate0_phases(card_vs_cpu, cfg, vae_sd, xy, device, zero_counts, read_counts, prefix):
    """``train_rate0`` (one loss and backward card against CPU) and
    ``train_rate0_step`` (one accumulated optimizer step) with the dropout
    rates at 0, on a randomized UNet of ``cfg`` cut to depth [1,1] (its counts
    from that model's routes).  Returns the step's launch counts."""
    import numpy as np
    import torch
    from prediff_torch.models.init import init_params_

    cfg0, weights0, per0 = depth1_unet(cfg, vae_sd, attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0,
                                       time_embed_dropout=0.0)
    ld0, trainer0 = card_vs_cpu(f"{prefix}train_rate0", cfg0, weights0, None,
                                expected_train_launches(per0, 1, 0, dropout=False))
    init_params_(ld0.unet, torch.Generator().manual_seed(SEED))
    state0 = trainer0.create_state()
    zero_counts()
    micro_ms = []
    for _ in range(TRAIN_ACCUM):
        t0 = time.perf_counter()
        state0, metrics0 = trainer0.train_step(state0, SEED, *xy)
        sync(device)
        micro_ms.append(1e3 * (time.perf_counter() - t0))
    launches0 = read_counts()
    expected0 = expected_train_launches(per0, TRAIN_ACCUM, 0, dropout=False)
    emit({"phase": f"{prefix}train_rate0_step", "micro_steps": state0.step,
          "optimizer_steps": state0.tx.count, "loss": float(metrics0["train/loss"]),
          "micro_ms": micro_ms, "depth": list(cfg0.model.latent_model.depth),
          "launches": launches0, "expected_launches": expected0})
    if (state0.tx.count != 1 or not np.isfinite(float(metrics0["train/loss"]))
            or launches0 != expected0):
        fail(f"{prefix}train_rate0: optimizer steps {state0.tx.count}, launches {launches0} != "
             f"{expected0}")
    del ld0, trainer0, state0
    return launches0


def recipe_trainer(ld, c, state_dtype=None, **kw):
    """The recipe's ``DiffusionTrainer`` on ``ld`` (``TRAIN_ACCUM`` micro-steps
    an update, the schedule of a ``TRAIN_SCHEDULE_STEPS`` run); ``kw`` its
    opt-ins (``remat_unet``, ``ema_dtype``), ``state_dtype`` the optimizer's."""
    from prediff_torch.training import DiffusionTrainer

    return DiffusionTrainer(ld, optim_config=dict(
        lr=c.optim.lr, total_num_steps=TRAIN_SCHEDULE_STEPS, method=c.optim.method,
        wd=c.optim.wd, betas=tuple(c.optim.betas), gradient_clip_val=c.optim.gradient_clip_val,
        warmup_percentage=c.optim.warmup_percentage,
        lr_scheduler_mode=c.optim.lr_scheduler_mode, min_lr_ratio=c.optim.min_lr_ratio,
        warmup_min_lr_ratio=c.optim.warmup_min_lr_ratio, accum_steps=TRAIN_ACCUM,
        state_dtype=state_dtype), use_ema=c.model.diffusion.use_ema, track_grad_norm=True, **kw)


def train_phases(device, cfg, smi, per_train, weights, zero_counts, read_counts, prefix="",
                 rate0=True, depth1=False, optins=False):
    """``train_rate0`` (dropout rates 0, depth [1,1]: ``rate0_phases``; not
    run when ``rate0`` is False), then ``train_grads``, ``train`` and
    ``profile_train_step`` at the configuration's own rates, all at its
    widths on ``device`` (``train_grads`` with the UNet cut to depth [1,1],
    the others at the configuration's depth, or at [1,1] too with ``depth1``),
    each phase's name after ``prefix``;
    ``per_train`` is ``path_launches``' count per micro-step of each kernel,
    ``weights`` the state dicts of "unet" and "vae"; ``optins``: then the
    trainer opt-ins' phases on the same pipeline (``optin_phases``).  Returns
    the kernels' launch counts of the ``train_rate0`` optimizer step and of
    the ``fit`` run."""
    import numpy as np
    import torch
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.models.init import init_params_
    from prediff_torch.training import DiffusionTrainer, fit
    from prediff_torch.utils.checkpoint import all_steps, restore_checkpoint

    B = cfg.optim.micro_batch_size
    d = cfg.model.diffusion
    rates = {k: cfg.model.latent_model[k]
             for k in ("attn_drop", "proj_drop", "ffn_drop", "time_embed_dropout")}
    if not (rates["attn_drop"] > 0 and rates["proj_drop"] > 0 and rates["ffn_drop"] > 0):
        fail(f"train: the configuration's dropout rates {rates} are not the recipe's")

    # The draws of the card-vs-CPU comparisons: z, zc, t, the noise and the dropout seed.
    rs = torch.Generator().manual_seed(SEED + 2)
    z = torch.randn((B,) + tuple(d.latent_shape), generator=rs)
    zc = torch.randn((B,) + tuple(d.latent_cond_shape), generator=rs)
    t = torch.randint(0, d.timesteps, (B,), generator=rs)
    noise = torch.randn(z.shape, generator=rs)
    logvar0 = 0.1 * torch.randn(d.timesteps, generator=rs)

    def loss_and_grads(ld, dropout_seed):
        dev = ld.device
        logvar = logvar0.to(dev).requires_grad_(True)
        loss, _ = ld.p_losses(logvar, z.to(dev), zc.to(dev), t.to(dev), noise.to(dev),
                              dropout_seed=dropout_seed)
        names = [f"unet.{k}" for k, _ in ld.unet.named_parameters()] + ["logvar"]
        grads = torch.autograd.grad(loss, list(ld.unet.parameters()) + [logvar])
        return float(loss.detach()), names, grads

    make_trainer = recipe_trainer

    def card_vs_cpu(phase, c, weights, dropout_seed, want_counts):
        """One loss and backward: the card (kernels) against the CPU (plain,
        f32, and with a seed the same masks), twice on the card; fails on a
        difference.  Returns the card's pipeline and its trainer."""
        t1 = time.perf_counter()
        ld_cpu = build_training_pipeline(c, device="cpu", params=weights)
        loss_cpu, names, grads_cpu = loss_and_grads(ld_cpu, dropout_seed)
        cpu_s = time.perf_counter() - t1
        del ld_cpu
        ld = build_training_pipeline(c, device=device, params=weights)
        trainer = make_trainer(ld, c)
        loss_and_grads(ld, dropout_seed)  # warm-up: cuDNN picks its algorithms for these shapes
        sync(device)
        zero_counts()
        loss_card, _, grads_card = loss_and_grads(ld, dropout_seed)
        sync(device)
        counts = read_counts()
        _, _, grads_again = loss_and_grads(ld, dropout_seed)
        sync(device)
        gc = [g.cpu().double().flatten() for g in grads_card]
        gr = [g.double().flatten() for g in grads_cpu]
        rel_l2, cosine = rel_l2_and_cosine(gc, gr)
        leaf_rel = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(gc, gr)]
        worst = int(np.argmax(leaf_rel))
        bit_equal = all(torch.equal(a, b) for a, b in zip(grads_card, grads_again))
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        emit({"phase": phase, "batch": B, "depth": list(c.model.latent_model.depth),
              "dropout": {k: c.model.latent_model[k] for k in rates},
              "dropout_seed": dropout_seed, "leaves": len(names), "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_rel_err": loss_rel, "tol_loss_rel": LOSS_TOL_REL,
              "grad_rel_l2_err": rel_l2, "grad_cosine": cosine, "tol_rel_l2": GRAD_TOL_REL_L2,
              "min_cosine": GRAD_MIN_COSINE, "worst_leaf": names[worst],
              "worst_leaf_rel_l2": leaf_rel[worst],
              "leaves_over_tol": sum(r > GRAD_TOL_REL_L2 for r in leaf_rel),
              "bit_equal_across_two_runs": bit_equal, "launches": counts,
              "expected_launches": want_counts, "cpu_loss_and_backward_s": cpu_s})
        if not all(torch.isfinite(g).all() for g in grads_card):
            fail(f"{phase}: non-finite gradient on the card")
        if loss_rel > LOSS_TOL_REL or rel_l2 > GRAD_TOL_REL_L2 or cosine < GRAD_MIN_COSINE:
            fail(f"{phase}: card differs from the CPU: loss {loss_rel}, gradient rel_l2 {rel_l2}, "
                 f"cosine {cosine}")
        if not bit_equal:
            fail(f"{phase}: two runs of the same backward on the card differ")
        if counts != want_counts:
            fail(f"{phase}: kernel launches {counts} != expected {want_counts}")
        return ld, trainer

    L = cfg.layout
    batch = torch.from_numpy(next(synthetic_batch_iterator(
        B, L.in_len + L.out_len, L.img_height, L.img_width, seed=SEED)))
    xy = (batch[:, L.in_len:].to(device), batch[:, :L.in_len].to(device))

    # The kernels without dropout: the rates at 0.
    launches_by_phase = {}
    if rate0:
        launches_by_phase[f"{prefix}train_rate0"] = rate0_phases(
            card_vs_cpu, cfg, weights["vae"], xy, device, zero_counts, read_counts, prefix)

    # The recipe's rates: one loss and backward, the card against the CPU, on a
    # randomized UNet cut to depth [1,1] (the same widths and shapes; the CPU's
    # backward at full depth took 30-45 s a phase).  fit below runs at full depth.
    cfg1, weights1, per1 = depth1_unet(cfg, weights["vae"])
    card_vs_cpu(f"{prefix}train_grads", cfg1, weights1, DROP_SEED,
                expected_train_launches(per1, 1, 0, dropout=True))
    if depth1:
        cfg, weights, per_train = cfg1, weights1, per1
    per_micro = expected_train_launches(per_train, 1, 0, dropout=True)
    ld = build_training_pipeline(cfg, device=device, params=weights)
    trainer = make_trainer(ld, cfg)

    # fit: a few accumulated optimizer steps on one synthetic batch repeated,
    # validation on the EMA weights, a checkpoint, its restore.  The UNet starts
    # from the seeded v1 initialisation, as a training run does (the randomized
    # weights above put every leaf's gradient to the test, but no run starts there).
    init_params_(ld.unet, torch.Generator().manual_seed(SEED))
    micro_steps = TRAIN_OPT_STEPS * TRAIN_ACCUM
    state = trainer.create_state()
    micro = []

    def timed_step(state, seed, x, y):
        sync(device)
        before = read_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, seed, x, y)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        after = read_counts()
        micro.append({"ms": ms, "loss": float(metrics["train/loss"]),
                      "grad_norm": float(metrics["grad_norm"]), "lr_next": state.tx.lr,
                      "launches": {k: after[k] - before[k] for k in after}})
        return state, metrics

    val_losses = []

    def val_fn(state):
        out = {k: float(v) for k, v in trainer.val_step(state, SEED, *xy, use_ema=True).items()}
        val_losses.append(out["val/loss"])
        return out

    # the same draws before and after, in eval mode (no dropout): the loss of
    # the trained (not the EMA) weights
    fixed_before = float(trainer.val_step(state, SEED, *xy, use_ema=False)["val/loss"])
    with tempfile.TemporaryDirectory() as save_dir:
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t1 = time.perf_counter()
        state = fit(state, timed_step, lambda epoch: [xy] * micro_steps, lambda b: b, max_epochs=1,
                    save_dir=save_dir, seed=SEED, val_fn=val_fn, max_steps=micro_steps,
                    log_every_n_steps=1)
        sync(device)
        fit_s = time.perf_counter() - t1
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        fixed_after = float(trainer.val_step(state, SEED, *xy, use_ema=False)["val/loss"])
        ckpt = os.path.join(save_dir, "ckpt")
        steps = all_steps(ckpt)
        ld2 = build_training_pipeline(cfg, device=device, seed=SEED + 7)
        fresh = DiffusionTrainer(ld2, optim_config=trainer.optim_config,
                                 use_ema=d.use_ema).create_state()
        restore_checkpoint(ckpt, fresh)
    a, b = state.state_dict(), fresh.state_dict()
    opt_a, opt_b = a["opt_state"]["optimizer"]["state"], b["opt_state"]["optimizer"]["state"]
    restored_equal = (
        a["step"] == b["step"] and a["opt_state"]["count"] == b["opt_state"]["count"]
        and all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
        and all(torch.equal(a["ema_params"][k], b["ema_params"][k]) for k in a["ema_params"])
        and all(torch.equal(opt_a[i][k], opt_b[i][k]) for i in opt_a for k in opt_a[i]))
    del ld2, fresh
    expected = expected_train_launches(per_train, micro_steps, len(val_losses), dropout=True)
    steady = sorted(m["ms"] for m in micro[2:])
    ms_per_micro = steady[len(steady) // 2]
    step_loss = [sum(m["loss"] for m in micro[i:i + TRAIN_ACCUM]) / TRAIN_ACCUM
                 for i in range(0, micro_steps, TRAIN_ACCUM)]
    emit({"phase": f"{prefix}train", "batch": B, "accum_steps": TRAIN_ACCUM, "dropout": rates,
          "pattern": cfg.model.latent_model.self_pattern,
          "optimizer_steps": state.tx.count,
          "micro_steps": state.step, "micro": micro, "loss_per_optimizer_step": step_loss,
          "ms_per_micro_step": ms_per_micro, "samples_per_s": 1e3 * B / ms_per_micro,
          "fit_seconds": fit_s, "peak_mem_gib": peak, "val_loss_ema": val_losses,
          "fixed_draw_loss_before": fixed_before, "fixed_draw_loss_after": fixed_after,
          "checkpoint_steps": steps, "restored_bit_equal": restored_equal, "launches": launches,
          "expected_launches": expected, "card": smi})
    phase = f"{prefix}train"
    if state.step != micro_steps or state.tx.count != TRAIN_OPT_STEPS:
        fail(f"{phase}: {state.step} micro-steps, {state.tx.count} optimizer steps")
    if not all(np.isfinite(m["loss"]) for m in micro) or not np.isfinite(val_losses).all():
        fail(f"{phase}: non-finite loss")
    if not fixed_after < fixed_before:
        fail(f"{phase}: the loss did not fall: {fixed_before} -> {fixed_after} (same batch and "
             "draws)")
    if any(m["launches"] != per_micro for m in micro) or launches != expected:
        fail(f"{phase}: kernel launches {launches} != expected {expected} "
             f"(per micro-step {[m['launches'] for m in micro]})")
    if steps != [micro_steps] or not restored_equal:
        fail(f"{phase}: checkpoint steps {steps}, restored state equal: {restored_equal}")

    emit(profile(f"profile_{prefix}train_step", lambda: trainer.train_step(state, SEED, *xy),
                 reps=2))
    if optins:
        del trainer, state
        optin_phases(device, cfg, smi, ld, xy, per_micro, zero_counts, read_counts)
    return dict(launches_by_phase, **{phase: launches})


# --------------------------------------------------------------------------- #
# The trainer opt-ins (remat_unet, bf16 Adam moments, a bf16 EMA shadow) and
# the profiling helpers (prediff_torch/utils/profiling.py).
OPTIN_REPS = 3           # timed micro-steps of each optin_remat run
OPTIN_UPDATE_ITERS = 5   # timed optimizer updates of each form
STEP_TIMER_CALLS = 5     # UNet forwards under StepTimer and CUDA events
STEP_TIMER_TOL_REL = 0.10
# the forward kernels that run inside the UNet's block pairs: recomputed under remat_unet
REMAT_FORWARDS = ("groupnorm_silu", "ffn", "ffn_dropout", "axial_attention",
                  "axial_attention_dropout", "cuboid_attention", "cuboid_attention_dropout",
                  "cuboid_attention_grouped")
FIRST_PROJ_GN = 2        # first_proj's two GN + SiLU forwards: outside every block pair


def remat_launches(per_micro: dict) -> dict:
    """A micro-step's launches under ``remat_unet``: each forward kernel of a
    block pair twice (its run and the backward's recompute), ``first_proj``'s
    GN forwards and every backward once."""
    out = dict(per_micro)
    for name in REMAT_FORWARDS:
        if out.get(name):
            out[name] += out[name] - (FIRST_PROJ_GN if name == "groupnorm_silu" else 0)
    return out


def to_cpu(tree):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    import torch

    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def within_bf16_ulp(got, want) -> float:
    """The largest excess of |got - want| over one bf16 ulp of the larger of
    the two plus 1e-6 of the tensor's largest value (what the f32 inputs'
    own differences give an element that cancels to near 0:
    tests/test_torch_trainer_optins.py); <= 0 when within."""
    import torch

    got, want = got.float().cpu(), want.float().cpu()
    a = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7) + 1e-6 * float(want.abs().max())
    return float(((got - want).abs() - ulp).max())


def optin_remat(device, smi, cfg, ld, xy, per_micro, zero_counts, read_counts):
    """``optin_remat``: one micro-step's loss and gradients (``grads``, no
    update) with and without ``remat_unet`` from the same state and seed,
    bit-equal; each run's launches (the forward kernels of the block pairs
    twice under remat), peak memory and ms per micro-step; then the peak and
    ms of the same step from first-stage moments (no encode in the step)."""
    import torch

    runs = {}
    for remat in (False, True):
        trainer = recipe_trainer(ld, cfg, remat_unet=remat)
        state = trainer.create_state()
        trainer.grads(state, SEED, *xy)        # warm-up
        sync(device)
        start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        grads, loss_dict = trainer.grads(state, SEED, *xy)
        sync(device)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        ms = []
        for _ in range(OPTIN_REPS):
            t0 = time.perf_counter()
            trainer.grads(state, SEED, *xy)
            sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        runs[remat] = dict(grads=grads, loss=loss_dict["train/loss"], counts=counts,
                           peak_gib=peak / 2**30, above_start_gib=(peak - start) / 2**30,
                           ms=median(ms))
        del trainer, state
    off, on = runs[False], runs[True]
    bit_equal = (torch.equal(off["loss"], on["loss"])
                 and all(torch.equal(a, b) for a, b in zip(off["grads"], on["grads"])))
    want = {False: dict(per_micro), True: remat_launches(per_micro)}
    leaves = len(on["grads"])
    del off["grads"], on["grads"]

    # the same micro-step from first-stage moments: the frozen VAE's encode,
    # whose own peak the pixel step's may be, drops out of it
    with torch.no_grad():
        moments = [ld.first_stage_moments(a.reshape((-1,) + tuple(a.shape[2:])))
                   for a in xy]
        mx, my = (m.reshape(tuple(a.shape[:2]) + tuple(m.shape[1:]))
                  for m, a in zip(moments, xy))
    for remat in (False, True):
        trainer = recipe_trainer(ld, cfg, remat_unet=remat, latent_inputs=True)
        state = trainer.create_state()
        trainer.grads(state, SEED, mx, my)
        sync(device)
        start = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        trainer.grads(state, SEED, mx, my)
        sync(device)
        runs[remat]["moments_above_start_gib"] = (torch.cuda.max_memory_allocated(device)
                                                  - start) / 2**30
        ms = []
        for _ in range(OPTIN_REPS):
            t0 = time.perf_counter()
            trainer.grads(state, SEED, mx, my)
            sync(device)
            ms.append(1e3 * (time.perf_counter() - t0))
        runs[remat]["moments_ms"] = median(ms)
        del trainer, state
    emit({"phase": "optin_remat", "batch": xy[0].shape[0],
          "depth": list(cfg.model.latent_model.depth), "leaves": leaves,
          "loss": float(on["loss"]), "bit_equal": bit_equal,
          "peak_gib": {"off": off["peak_gib"], "on": on["peak_gib"]},
          "peak_above_start_gib": {"off": off["above_start_gib"], "on": on["above_start_gib"]},
          "ms_per_micro_step": {"off": off["ms"], "on": on["ms"]},
          "moments_peak_above_start_gib": {"off": off["moments_above_start_gib"],
                                           "on": on["moments_above_start_gib"]},
          "moments_ms": {"off": off["moments_ms"], "on": on["moments_ms"]},
          "launches": {"off": off["counts"], "on": on["counts"]},
          "expected_launches": {"off": want[False], "on": want[True]}, "card": smi})
    if not bit_equal:
        fail("optin_remat: the loss or a gradient under remat_unet differs from the step "
             "without it")
    for remat in (False, True):
        if runs[remat]["counts"] != want[remat]:
            fail(f"optin_remat (remat_unet={remat}): launches {runs[remat]['counts']} != "
                 f"{want[remat]}")


def optin_bf16_state(device, smi, cfg, ld, xy):
    """``optin_bf16_state``: ``state_dtype`` and ``ema_dtype`` "bfloat16",
    two accumulated optimizer steps from the seeded initialisation; the
    stored moments and shadow bf16; one more update on the card against the
    same update on the CPU from the same state and gradients (parameters
    within 1e-5, moments and shadow within one bf16 ulp); their bytes in f32
    and bf16, and the ms of one update, bf16 against the fused f32 AdamW."""
    import torch
    from prediff_torch.models.init import init_params_
    from prediff_torch.training import EmaTrainState, build_optimizer, ema_update

    init_params_(ld.unet, torch.Generator().manual_seed(SEED))
    trainer = recipe_trainer(ld, cfg, state_dtype="bfloat16", ema_dtype="bfloat16")
    state = trainer.create_state()
    for _ in range(2 * TRAIN_ACCUM):
        state, metrics = trainer.train_step(state, SEED, *xy)
    sync(device)
    moments = [v for st in state.tx.optimizer.state.values() for v in st.values()]
    stored_bf16 = (len(moments) == 2 * len(state.params)
                   and all(v.dtype == torch.bfloat16 for v in moments)
                   and all(e.dtype == torch.bfloat16 for e in state.ema_params.values()))

    # one update, the card against the CPU from the same state and gradients
    saved = to_cpu(state.state_dict())
    g1, _ = trainer.grads(state, SEED + 1, *xy)
    g2, _ = trainer.grads(state, SEED + 2, *xy)
    state.apply_gradients(g1)
    state.apply_gradients(g2)
    params_cpu = {k: torch.nn.Parameter(v.clone()) for k, v in saved["params"].items()}
    cpu = EmaTrainState.create(params_cpu, build_optimizer(list(params_cpu.values()),
                                                           **trainer.optim_config),
                               use_ema=state.use_ema, ema_decay=state.ema_decay,
                               ema_dtype="bfloat16")
    cpu.load_state_dict(saved)
    cpu.apply_gradients([g.cpu() for g in g1])
    cpu.apply_gradients([g.cpu() for g in g2])
    param_excess = max(float(((p.detach().cpu() - cpu.params[k].detach()).abs()
                              - 1e-5 * (1.0 + cpu.params[k].detach().abs())).max())
                       for k, p in state.params.items())
    card_st, cpu_st = state.tx.optimizer.state, cpu.tx.optimizer.state
    moment_excess = max(within_bf16_ulp(card_st[p][key], cpu_st[q][key])
                        for p, q in zip(state.params.values(), cpu.params.values())
                        for key in ("exp_avg", "exp_avg_sq"))
    shadow_excess = max(within_bf16_ulp(e, cpu.ema_params[k]) for k, e in state.ema_params.items())

    # the bytes held, and one update of each form on copies of the parameters
    n = sum(p.numel() for p in state.params.values())

    def update_ms(state_dtype):
        ps = [torch.nn.Parameter(p.detach().clone()) for p in state.params.values()]
        tx = build_optimizer(ps, **dict(trainer.optim_config, accum_steps=1,
                                        state_dtype=state_dtype))
        tx.update(g1)     # the state made
        ms = time_ms(lambda: tx.update(g1), warmup=1, iters=OPTIN_UPDATE_ITERS)
        held = sum(v.numel() * v.element_size() for st in tx.optimizer.state.values()
                   for v in st.values() if v.dim() > 0)
        return ms, held, bool(tx.optimizer.defaults.get("fused"))

    f32_ms, f32_bytes, fused = update_ms(None)
    bf16_ms, bf16_bytes, _ = update_ms("bfloat16")
    shadows = {dt: [p.detach().to(dt, copy=True) for p in state.params.values()]
               for dt in (torch.float32, torch.bfloat16)}
    ema_ms = {str(dt).split(".")[-1]: time_ms(
        lambda s=s: ema_update(s, list(state.params.values()), 0.9999, 100), warmup=1,
        iters=OPTIN_UPDATE_ITERS) for dt, s in shadows.items()}
    emit({"phase": "optin_bf16_state", "batch": xy[0].shape[0], "accum_steps": TRAIN_ACCUM,
          "optimizer_steps": state.tx.count, "micro_steps": state.step,
          "loss": float(metrics["train/loss"]), "params": n, "stored_bf16": stored_bf16,
          "update_card_vs_cpu": {"param_excess_over_1e-5": param_excess,
                                 "moment_excess_over_ulp": moment_excess,
                                 "shadow_excess_over_ulp": shadow_excess},
          "moment_mb": {"float32": f32_bytes / 1e6, "bfloat16": bf16_bytes / 1e6},
          "shadow_mb": {"float32": 4 * n / 1e6,
                        "bfloat16": sum(e.numel() * e.element_size()
                                        for e in state.ema_params.values()) / 1e6},
          "update_ms": {"float32_fused": f32_ms, "bfloat16": bf16_ms}, "f32_fused": fused,
          "ema_update_ms": ema_ms, "card": smi})
    if state.tx.count != 3 or not stored_bf16:
        fail(f"optin_bf16_state: {state.tx.count} optimizer steps, stored bf16: {stored_bf16}")
    if not (param_excess <= 0 and moment_excess <= 0 and shadow_excess <= 0):
        fail(f"optin_bf16_state: the card's update differs from the CPU's: parameters "
             f"{param_excess}, moments {moment_excess}, shadow {shadow_excess} beyond tolerance")


def optin_phases(device, cfg, smi, ld, xy, per_micro, zero_counts, read_counts):
    """The trainer opt-ins on the training pipeline ``ld`` of ``train_phases``
    (the v1 recipe at its depth and dropout rates, pixel inputs ``xy`` at the
    training micro-batch): ``optin_remat``, then ``optin_bf16_state``."""
    optin_remat(device, smi, cfg, ld, xy, per_micro, zero_counts, read_counts)
    optin_bf16_state(device, smi, cfg, ld, xy)


# --------------------------------------------------------------------------- #
# steps_per_call: K diffusion micro-steps per call, replays of captured CUDA
# graphs (training/step_graphs.py), and the dropout kernels' device-seed form.
SCAN_K = 4               # micro-steps per call
SCAN_CALLS = 3           # calls from pixels: 12 micro-steps, 6 optimizer steps at accum 2
SCAN_MOMENT_CALLS = 2    # calls from first-stage moments: 8 micro-steps
# scan_optins: each trainer's calls from moments, and the remat trainer's from pixels
SCAN_OPTINS = {"remat": dict(remat_unet=True),
               "bf16_state": dict(state_dtype="bfloat16", ema_dtype="bfloat16")}
SCAN_OPTIN_CALLS = 2
SCAN_OPTIN_PIXEL_CALLS = 2   # the first call captures: the second times the replays
SCAN_MESH_CALLS = 2      # scan_mesh: calls of each rank (gloo), of the NCCL rank
SCAN_MESH_TIMEOUT_S = 600    # a rank that has not finished by then is killed and the phase fails
# rows 15a-15d with the seed read from the card (ops/dropout.device_seed): the
# int-seed form each was held against, on the train_scan path
SCAN_FORMS = {"ffn_dropout_devseed": "ffn_dropout",
              "ffn_dropout_bwd_full_devseed": "ffn_dropout_bwd_full",
              "axial_attention_dropout_devseed": "axial_attention_dropout",
              "axial_attention_dropout_bwd_full_devseed": "axial_attention_dropout_bwd_full"}
SCAN_KERNELS = {k: KERNELS[v][:2] + ("train_scan",) for k, v in SCAN_FORMS.items()}
PATH_WEIGHTS["train_scan"] = ("per_train",)


def check_devseed_kernels(cases, device):
    """Rows 15a-15d with a device seed at the training micro-step's shapes
    (the int-seed forms' ``per_train`` cases): bit-equal to the int-seed form
    on the same seed; against the plain version (which takes the device seed
    too) at base 0 and at ``DROP_BASES``, at the int-seed forms' bars; the
    times, the device time alone beside the int-seed form's in the same run.
    Returns the cases, one list per form, and the failed ones."""
    import torch
    from prediff_torch.ops.attention import (axial_attention_bwd_full_plain,
                                             axial_attention_plain,
                                             fused_axial_attention_dropout,
                                             fused_axial_attention_dropout_bwd_full)
    from prediff_torch.ops.dropout import device_seed
    from prediff_torch.ops.ffn import (ffn_dropout_bwd_full_plain, ffn_dropout_plain,
                                       fused_ffn_dropout, fused_ffn_dropout_bwd_full)

    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    bf16 = torch.bfloat16
    seed_t = device_seed(DROP_SEED, device)
    heads = 4

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    out = {k: [dict(shape=c["shape"], per_train=c["per_train"],
                    **({"axis": c["axis"]} if "axis" in c else {}))
               for c in cases[v] if c["per_train"]] for k, v in SCAN_FORMS.items()}
    for name, cs in out.items():
        for c in cs:
            if name.startswith("ffn"):
                M, C = c["shape"]
                hid = 4 * C
                x, ln_w, ln_b = randn(M, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
                w1, b1 = randn(hid, C, scale=C ** -0.5), randn(hid, scale=0.1)
                w2, b2 = randn(C, hid, scale=hid ** -0.5), randn(C, scale=0.1)
                if name == "ffn_dropout_devseed":
                    args = (x, ln_w, ln_b, w1, b1, w2, b2, 1e-5)
                    kernel, plain = fused_ffn_dropout, ffn_dropout_plain
                    nbytes, flops, outs = (4 * (2 * M * C + 2 * C * hid + hid + 3 * C),
                                           4 * M * C * hid, None)
                else:
                    args = (x, randn(M, C), ln_w, ln_b, w1, b1, w2, 1e-5)
                    kernel, plain = fused_ffn_dropout_bwd_full, ffn_dropout_bwd_full_plain
                    nbytes, flops = (4 * (3 * M * C + 4 * C * hid + 2 * hid + 5 * C),
                                     10 * M * C * hid)
                    outs = ("dx", "dln_w", "dln_b", "dw1", "db1", "dw2", "db2")

                def call(fn, seed, bases=(0, 0), **kw):
                    return fn(*args, DROP_RATE, DROP_RATE, seed, DROP_SITE, bases=bases, **kw)
            else:
                B, T, H, W, C = c["shape"]
                axis = c["axis"]
                vol = (T, H, W)[axis]
                M = B * T * H * W
                x, ln_w, ln_b = randn(B, T, H, W, C), randn(C, scale=0.1, shift=1.0), randn(
                    C, scale=0.1)
                w_qkv, bias = randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5)
                w_proj, b_proj = randn(C, C, scale=C ** -0.5), randn(C, scale=0.1)
                scale = (C // heads) ** -0.5
                if name == "axial_attention_dropout_devseed":
                    args = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale, 1e-5)
                    kernel, plain = fused_axial_attention_dropout, axial_attention_plain
                    nbytes = 4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C)
                    flops, outs = 8 * M * C * C + 4 * M * vol * C, None
                else:
                    args = (x, randn(B, T, H, W, C), axis, ln_w, ln_b, w_qkv, bias, w_proj,
                            heads, scale, 1e-5)
                    kernel = fused_axial_attention_dropout_bwd_full
                    plain = axial_attention_bwd_full_plain
                    nbytes = 4 * (3 * M * C + 8 * C * C + 2 * heads * vol * vol + 5 * C)
                    flops = 22 * M * C * C + 12 * M * vol * C
                    outs = ("dx", "dln_w", "dln_b", "dw_qkv", "dbias", "dw_proj", "db_proj")

                def call(fn, seed, bases=(0, 0), **kw):
                    if fn is axial_attention_plain or fn is axial_attention_bwd_full_plain:
                        return fn(*args, bf16, DROP_RATE, DROP_RATE, seed, DROP_SITE,
                                  bases=bases)
                    return fn(*args, DROP_RATE, DROP_RATE, seed, DROP_SITE, bases=bases)

            plain_kw = {"mxu_dtype": bf16} if name.startswith("ffn") else {}
            got, by_int = call(kernel, seed_t), call(kernel, DROP_SEED)
            want = call(plain, seed_t, **plain_kw)
            sync(device)
            if outs is None:
                judge(c, got, want, tol=2e-2)
                equal = torch.equal(got, by_int)
            else:
                judge_all(c, outs, got, want)
                equal = all(torch.equal(a, b) for a, b in zip(got, by_int))
            c["bit_equal_to_int_seed"] = equal
            c["ok"] = c["ok"] and equal
            judge_base(c, lambda b: call(kernel, seed_t, b),
                       lambda b: call(plain, seed_t, b, **plain_kw), outs)
            timed(c, lambda: call(kernel, seed_t), lambda: call(plain, seed_t, **plain_kw),
                  nbytes, device_time=True, bf16_flops=flops)
            c["int_seed_device_ms"] = graph_time_ms(lambda: call(kernel, DROP_SEED))
    failed = [(n, c) for n, cs in out.items() for c in cs if not c["ok"]]
    return out, failed


def scan_state_equal(a, b) -> dict:
    """Which parts of two train states are bit-equal (and of one dtype): the
    parameters, each tensor of the optimizer's per-parameter state (both Adam
    moments, the fused optimizer's step counts), the EMA shadow, the
    accumulated gradients, the host's counters."""
    import torch

    def same(x, y):
        return x.dtype == y.dtype and torch.equal(x, y)

    sa, sb = a.tx.optimizer.state, b.tx.optimizer.state
    pa, pb = list(a.params.values()), list(b.params.values())
    keys = sorted({k for st in sa.values() for k, v in st.items() if isinstance(v, torch.Tensor)})
    moments = {k: all(same(sa[p][k], sb[q][k]) for p, q in zip(pa, pb)) for k in keys}
    acc_a, acc_b = a.tx.acc_grads or [], b.tx.acc_grads or []
    return {"params": all(same(p, q) for p, q in zip(pa, pb)), **moments,
            "ema": all(same(a.ema_params[k], b.ema_params[k]) for k in a.ema_params),
            "acc_grads": len(acc_a) == len(acc_b) and all(map(same, acc_a, acc_b)),
            "counters": a.counters() == b.counters()}


def stack_moments(ld, stack, device):
    """First-stage moments of a (n, B, T, H, W, C) stack of pixel windows, on
    ``device``, one micro-batch at a time."""
    import torch

    def moments(a):
        m = ld.first_stage_moments(a.reshape((-1,) + tuple(a.shape[2:])))
        return m.reshape(tuple(a.shape[:2]) + tuple(m.shape[1:]))

    with torch.no_grad():
        return torch.stack([moments(a.to(device)) for a in stack])


def scan_against_eager(device, lds, cfg, xs, ys, calls, per_micro, zero_counts, read_counts,
                       latent=False, **optins) -> dict:
    """``calls`` calls of ``train_step_scan`` (K = ``SCAN_K``) of the
    recipe's trainer with ``optins`` (``remat_unet``, ``state_dtype``,
    ``ema_dtype``) on the pipeline ``lds[1]`` against as many eager
    ``train_step`` calls on ``lds[0]`` from the same state, on the (n, B, ...)
    pixel stacks ``xs``, ``ys`` (``latent``: their first-stage moments): bit
    for bit (the state, every metric), the launches of the scan run and per
    replay against ``per_micro`` a micro-step, ms per micro-step both ways
    (the last call's), the last call's replays' device ms and busy share, the
    captures' seconds and pool."""
    import numpy as np
    import torch

    n = SCAN_K * calls
    names = {fn.__name__: name for name, fn in COUNTERS.items()}
    eager_tr, scan_tr = (recipe_trainer(ld, cfg, latent_inputs=latent, **optins) for ld in lds)
    if latent:
        xk, yk = stack_moments(lds[0], xs[:n], device), stack_moments(lds[0], ys[:n], device)
    else:
        xk, yk = xs[:n], ys[:n]
        if device.type == "cuda":
            xk, yk = xk.pin_memory(), yk.pin_memory()
    eager, scanned = eager_tr.create_state(), scan_tr.create_state()
    ex, ey = xk.to(device), yk.to(device)
    eager_ms, eager_metrics = [], []
    for k in range(n):
        sync(device)
        t0 = time.perf_counter()
        eager, m = eager_tr.train_step(eager, SEED, ex[k], ey[k])
        sync(device)
        eager_ms.append(1e3 * (time.perf_counter() - t0))
        eager_metrics.append(m)
    sync(device)
    zero_counts()
    call_ms, metrics = [], []
    graphs = None
    for c in range(calls):
        if c == calls - 1 and scan_tr.scan_graphs is not None:
            scan_tr.scan_graphs.timing = []
        t0 = time.perf_counter()
        scanned, m = scan_tr.train_step_scan(scanned, SEED, xk[c * SCAN_K:(c + 1) * SCAN_K],
                                             yk[c * SCAN_K:(c + 1) * SCAN_K])
        sync(device)
        call_ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append(m)
        graphs = scan_tr.scan_graphs
    counts = {k: v for k, v in read_counts().items() if v}
    replays = graphs.timing or []
    replay_ms = [s.elapsed_time(e) for _, s, e in replays]
    graphs.timing = None
    equal = scan_state_equal(eager, scanned)
    keys = list(eager_metrics[0])
    metric_equal = all(torch.equal(torch.stack([e[k] for e in eager_metrics]),
                                   torch.cat([m[k] for m in metrics])) for k in keys)
    per_replay = {kind: {names.get(fn, fn): v for fn, v in d.items()}
                  for kind, d in graphs.launches_per_replay().items()}
    steady = call_ms[-1] / SCAN_K
    device_ms = float(np.mean(replay_ms)) if replay_ms else None
    out = {"micro_steps": n, "calls": calls, "k": SCAN_K, "optins": optins, "bit_equal": equal,
           "metrics_bit_equal": metric_equal, "metric_keys": keys,
           "optimizer_steps": scanned.tx.count, "step": scanned.step,
           "loss": [float(v) for m in metrics for v in m["train/loss"]],
           "call_ms": call_ms, "ms_per_micro_step": steady,
           "eager_ms_per_micro_step": median(eager_ms[2:]), "eager_ms": eager_ms,
           "replay_device_ms": device_ms, "replays_timed": len(replay_ms),
           "busy_share": None if device_ms is None else device_ms / steady,
           "captures": graphs.captures, "capture_s": graphs.capture_seconds,
           "pool_gib": graphs.pool_bytes() / 2**30, "launches": counts,
           "expected_launches": {k: v * n for k, v in per_micro.items()},
           "launches_per_replay": per_replay, "expected_per_replay": per_micro}
    del eager_tr, scan_tr, eager, scanned, ex, ey, graphs
    return out


def check_scan_run(phase: str, what: str, r: dict) -> None:
    """Fail ``phase`` unless the run ``r`` of ``scan_against_eager`` is bit-equal
    to its eager calls, launched as expected in all and per replay of each
    kind, and finite."""
    import numpy as np

    if not (all(r["bit_equal"].values()) and r["metrics_bit_equal"]):
        fail(f"{phase} ({what}): not bit-equal to eager train_step: {r['bit_equal']}, "
             f"metrics {r['metrics_bit_equal']}")
    if r["launches"] != r["expected_launches"]:
        fail(f"{phase} ({what}): launches {r['launches']} != {r['expected_launches']}")
    per = r["expected_per_replay"]
    if any(d != per for d in r["launches_per_replay"].values()) or \
            sorted(r["launches_per_replay"]) != ["accumulate", "update"]:
        fail(f"{phase} ({what}): launches per replay {r['launches_per_replay']} != {per} for "
             "each kind")
    if not np.isfinite(r["loss"]).all():
        fail(f"{phase} ({what}): non-finite loss")


def memory_left(device) -> dict:
    """What this process's caching allocator holds on the card (GiB): reserved
    and allocated, and its largest segments (size, allocated, graph pool id,
    stream, live blocks)."""
    import torch

    segments = torch.cuda.memory_snapshot()
    largest = []
    for s in sorted(segments, key=lambda s: -s["total_size"])[:6]:
        live = [b for b in s["blocks"] if b["state"] == "active_allocated"]
        largest.append({"gib": s["total_size"] / 2**30,
                        "allocated_gib": s["allocated_size"] / 2**30,
                        "pool": list(s.get("segment_pool_id", ())), "stream": s["stream"],
                        "live_blocks": len(live)})
    return {"reserved_gib": torch.cuda.memory_reserved(device) / 2**30,
            "allocated_gib": torch.cuda.memory_allocated(device) / 2**30,
            "segments": len(segments), "largest": largest}


def train_scan(device, smi, cfg, weights, per_train, zero_counts, read_counts) -> dict:
    """``train_scan``: the recipe's trainer (rates 0.1, B=2, accum 2) with
    ``steps_per_call`` K = ``SCAN_K``: ``SCAN_CALLS`` calls of
    ``train_step_scan`` from pixels against as many eager ``train_step``
    calls from the same state on a second pipeline of the same weights,
    bit for bit (parameters, moments, shadow, counters, every metric), the
    launches of the run and per replay, ms per micro-step both ways, the
    replays' device ms and busy share, the captures' seconds and pool; then
    ``SCAN_MOMENT_CALLS`` calls from first-stage moments likewise; then
    ``train_scan_released``, what the card holds once its pipelines and
    graphs are gone.  Returns the wrappers' launches of the pixel run."""
    import torch

    lds, xs, ys = scan_pipelines(device, cfg, weights, SCAN_K * SCAN_CALLS)
    per_micro = {k: v for k, v in expected_train_launches(per_train, 1, 0, True).items() if v}
    t1 = time.perf_counter()
    pixels = scan_against_eager(device, lds, cfg, xs, ys, SCAN_CALLS, per_micro, zero_counts,
                                read_counts)
    pixel_s = time.perf_counter() - t1
    moments = scan_against_eager(device, lds, cfg, xs, ys, SCAN_MOMENT_CALLS, per_micro,
                                 zero_counts, read_counts, latent=True)
    emit({"phase": "train_scan", "batch": cfg.optim.micro_batch_size,
          "accum_steps": TRAIN_ACCUM, "depth": list(cfg.model.latent_model.depth),
          "dropout": {k: cfg.model.latent_model[k] for k in ("attn_drop", "proj_drop", "ffn_drop")},
          "pixels": pixels, "moments": moments, "pixel_run_s": pixel_s,
          "torch": torch.__version__, "card": smi})
    for what, r in (("pixels", pixels), ("moments", moments)):
        check_scan_run("train_scan", what, r)
    if pixels["optimizer_steps"] != SCAN_K * SCAN_CALLS // TRAIN_ACCUM:
        fail(f"train_scan: {pixels['optimizer_steps']} optimizer steps")
    PHASE_NUMBERS["train_scan_pool_gib"] = {"pixels": pixels["pool_gib"],
                                            "moments": moments["pool_gib"]}
    # what the phase leaves reserved once its pipelines and graphs are gone
    del lds
    emit({"phase": "train_scan_released", **release_scan_memory(device)})
    return pixels["launches"]


def release_scan_memory(device) -> dict:
    """Once the scan phase's pipelines and trainers are dropped: collect,
    free the cuBLAS workspaces (``graphs.release_workspaces``, which raises
    while a captured graph is alive), give back the cache, and say what the
    card still holds (``memory_left``)."""
    import torch
    from prediff_torch.diffusion.graphs import release_workspaces

    gc.collect()
    release_workspaces()
    torch.cuda.empty_cache()
    return memory_left(device)


def scan_pipelines(device, cfg, weights, n: int):
    """Two training pipelines of ``cfg`` on ``weights`` with the UNet from
    the seeded initialisation, and ``n`` synthetic micro-batches of pixel
    windows stacked (n, B, ...) as targets and contexts."""
    import numpy as np
    import torch
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.models.init import init_params_

    B, L = cfg.optim.micro_batch_size, cfg.layout
    it = synthetic_batch_iterator(B, L.in_len + L.out_len, L.img_height, L.img_width,
                                  seed=SEED + 5)
    batches = torch.from_numpy(np.stack([next(it) for _ in range(n)]))
    lds = []
    for _ in range(2):
        ld = build_training_pipeline(cfg, device=device, params=weights)
        init_params_(ld.unet, torch.Generator().manual_seed(SEED))
        lds.append(ld)
    return (lds, batches[:, :, L.in_len:].contiguous(), batches[:, :, :L.in_len].contiguous())


def scan_optins(device, smi, cfg, weights, per_train, zero_counts, read_counts) -> dict:
    """``scan_optins``: the recipe's trainer with ``steps_per_call`` K =
    ``SCAN_K`` and each of ``SCAN_OPTINS`` (``remat_unet``; bf16 Adam moments
    and EMA shadow): ``SCAN_OPTIN_CALLS`` calls from first-stage moments each,
    and the remat trainer's ``SCAN_OPTIN_PIXEL_CALLS`` from pixels, each
    against as many eager ``train_step`` calls on a second pipeline of the same
    weights, bit for bit (parameters, both moments, the shadow, the counters,
    every metric), with ms per micro-step both ways, the replays' device ms and
    busy share, launches per replay (remat: the block pairs' forward kernels
    twice), capture seconds and pool GiB beside ``train_scan``'s (no opt-in).
    Returns the launches of the remat trainer's moment run."""
    n = SCAN_K * max(SCAN_OPTIN_CALLS, SCAN_OPTIN_PIXEL_CALLS)
    lds, xs, ys = scan_pipelines(device, cfg, weights, n)
    per_micro = {k: v for k, v in expected_train_launches(per_train, 1, 0, True).items() if v}
    runs = {}
    for name, optins in SCAN_OPTINS.items():
        per = remat_launches(per_micro) if optins.get("remat_unet") else per_micro
        runs[name] = {"moments": scan_against_eager(device, lds, cfg, xs, ys, SCAN_OPTIN_CALLS,
                                                    per, zero_counts, read_counts, latent=True,
                                                    **optins)}
        if optins.get("remat_unet"):
            runs[name]["pixels"] = scan_against_eager(device, lds, cfg, xs, ys,
                                                      SCAN_OPTIN_PIXEL_CALLS, per, zero_counts,
                                                      read_counts, **optins)
    del lds
    emit({"phase": "scan_optins", "batch": cfg.optim.micro_batch_size,
          "accum_steps": TRAIN_ACCUM, "depth": list(cfg.model.latent_model.depth), **runs,
          "pool_gib_without_optins": PHASE_NUMBERS.get("train_scan_pool_gib"), "card": smi,
          "released": release_scan_memory(device)})
    for name, by_input in runs.items():
        for what, r in by_input.items():
            check_scan_run("scan_optins", f"{name}, {what}", r)
    return runs["remat"]["moments"]["launches"]


def scan_mesh_phases(device, smi, cfg, weights, per) -> dict:
    """``scan_mesh``: ``train_step_scan`` on a mesh, in ranks that are child
    processes of this script (``--scan-child``), each held to its share of the
    card (``rank_memory_share``): two gloo ranks at the recipe's widths cut to
    depth [1,1], one sample a rank, ``SCAN_MESH_CALLS`` calls of K =
    ``SCAN_K`` from moments on the split graphs (the loss and gradients, the
    host all-reduce, the update), each rank's state bit-equal to as many eager
    mesh micro-steps of that rank after every call and the ranks to each
    other, the host all-reduce's ms a micro-step; then rank 0 alone in an NCCL
    group of one at full depth, as many calls with the all-reduce inside the
    graph, bit-equal to its eager mesh micro-steps and to the scan without a
    mesh.  Returns rank 0's launches by phase."""
    import torch
    from prediff_torch.config import save_yaml

    t_all = time.perf_counter()
    cfg1, weights1, per1 = depth1_unet(cfg, weights["vae"])
    with tempfile.TemporaryDirectory() as root:
        save_yaml(cfg, os.path.join(root, "cfg.yaml"))
        save_yaml(cfg1, os.path.join(root, "cfg1.yaml"))
        torch.save({"full": {"unet": weights["unet"], "vae": weights["vae"]}, "depth1": weights1},
                   os.path.join(root, "weights.pt"))
        with open(os.path.join(root, "plan.json"), "w") as f:
            json.dump({"device": str(device), "port": free_port(), "port2": free_port(),
                       "nccl_backend": "nccl" if device.type == "cuda" else "gloo",
                       "per1": per1, "per": {k: v["per_train"] for k, v in per.items()}}, f)
        children = run_ranks("scan", root, "scan", SCAN_MESH_TIMEOUT_S, device)
        res = []
        for r in range(2):
            with open(os.path.join(root, f"scan{r}.json")) as f:
                res.append(json.load(f))
    launches = {}
    for name in ("scan_mesh_gloo", "scan_mesh_nccl"):
        line = {"phase": name, **res[0][name], "card": smi}
        if name in res[1]:
            line["rank1"] = {k: v for k, v in res[1][name].items()
                             if k in ("launches", "ms_per_micro_step", "host_all_reduce_ms",
                                      "bit_equal_per_call", "failed")}
            line["ms_are"] = "two ranks sharing one card: not scaling"
        emit(line)
        failed = list(res[0][name]["failed"]) + list(res[1].get(name, {}).get("failed", []))
        if failed:
            fail(f"{name}: {failed}")
        launches[name] = res[0][name]["launches"]
    emit({"phase": "scan_mesh", "seconds": time.perf_counter() - t_all, **children,
          "rank_stages_s": [r["stages_s"] for r in res],
          "rank_peak_gib_by_stage": [r["peak_gib_by_stage"] for r in res], "card": smi})
    return launches


def scan_child(root: str, rank: int) -> int:
    """One rank of ``scan_mesh_phases`` (``--scan-child ROOT RANK``): its
    results in ``ROOT/scan{RANK}.json``; a failed check is listed there, an
    error exits non-zero."""
    import torch
    import torch.distributed as dist
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.parallel import init_distributed, make_mesh
    from prediff_torch.parallel.mesh import gather_parts
    from prediff_torch.utils.device import set_numerics

    stages = {"imports": time.perf_counter() - T0}
    peaks = {}

    def stage(name):
        sync(device)
        stages[name] = time.perf_counter() - T0
        progress(device, name, stages[name], peaks)

    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    device = torch.device(plan["device"])
    rank_memory_share(device)
    set_numerics()
    zero_counts, read_counts = kernel_counters()
    names = {fn.__name__: name for name, fn in COUNTERS.items()}
    weights = torch.load(os.path.join(root, "weights.pt"))
    out = {"stages_s": stages, "peak_gib_by_stage": peaks}

    def per_micro(per_train):
        return {k: v for k, v in expected_train_launches(per_train, 1, 0, True).items() if v}

    def by_name(graphs):
        return {kind: {names.get(fn, fn): v for fn, v in d.items()}
                for kind, d in graphs.launches_per_replay().items()}

    def run(cfg, ld_weights, mesh, batch, rows, calls, per, no_mesh=False):
        """Eager mesh micro-steps against ``train_step_scan`` on the mesh,
        call by call, from moments of ``batch`` global samples (this rank's
        ``rows``); ``no_mesh``: also the scan without a mesh."""
        img = cfg.layout
        rs = torch.Generator().manual_seed(SEED + 61)
        n = SCAN_K * calls
        x = torch.rand((n, batch, img.out_len, img.img_height, img.img_width,
                        img.data_channels), generator=rs)[:, rows]
        y = torch.rand((n, batch, img.in_len, img.img_height, img.img_width,
                        img.data_channels), generator=rs)[:, rows]
        lds = [build_training_pipeline(cfg, device=device, params=ld_weights)
               for _ in range(3 if no_mesh else 2)]
        xk, yk = stack_moments(lds[0], x, device), stack_moments(lds[0], y, device)
        meshes = [mesh, mesh] + ([None] if no_mesh else [])
        trainers = [recipe_trainer(ld, cfg, latent_inputs=True, mesh=m)
                    for ld, m in zip(lds, meshes)]
        states = [tr.create_state() for tr in trainers]
        line = {"depth": list(cfg.model.latent_model.depth), "samples_per_rank": xk.shape[1],
                "k": SCAN_K, "calls": calls, "backend": mesh.backend, "ranks": mesh.size,
                "bit_equal_per_call": [], "metrics_bit_equal_per_call": [], "failed": []}
        eager_ms, call_ms, counts = [], [], {}
        for c in range(calls):
            chunk = slice(c * SCAN_K, (c + 1) * SCAN_K)
            want = []
            for k in range(chunk.start, chunk.stop):
                sync(device)
                t0 = time.perf_counter()
                states[0], m = trainers[0].train_step(states[0], SEED, xk[k], yk[k])
                sync(device)
                eager_ms.append(1e3 * (time.perf_counter() - t0))
                want.append(m)
            want = {k: torch.stack([m[k] for m in want]) for k in want[0]}
            graphs = trainers[1].scan_graphs
            if c == calls - 1 and graphs is not None:
                graphs.timing, graphs.reduce_ms = [], []
            zero_counts()
            sync(device)
            t0 = time.perf_counter()
            states[1], got = trainers[1].train_step_scan(states[1], SEED, xk[chunk], yk[chunk])
            sync(device)
            call_ms.append(1e3 * (time.perf_counter() - t0))
            for key, v in read_counts().items():
                if v:
                    counts[key] = counts.get(key, 0) + v
            equal = scan_state_equal(states[0], states[1])
            line["bit_equal_per_call"].append(equal)
            line["metrics_bit_equal_per_call"].append(
                all(torch.equal(want[k], got[k]) for k in want))
            if no_mesh:
                states[2], alone = trainers[2].train_step_scan(states[2], SEED, xk[chunk],
                                                               yk[chunk])
                line["bit_equal_to_no_mesh"] = scan_state_equal(states[1], states[2])
                line["metrics_bit_equal_to_no_mesh"] = all(torch.equal(got[k], alone[k])
                                                           for k in got)
        graphs = trainers[1].scan_graphs
        replay_ms = [s.elapsed_time(e) for _, s, e in graphs.timing or []]
        steady = call_ms[-1] / SCAN_K
        line.update(
            split=graphs.split, graphs=sorted(graphs.graphs), launches=counts,
            expected_launches={k: v * n for k, v in per.items()},
            launches_per_replay=by_name(graphs), ms_per_micro_step=steady,
            eager_ms_per_micro_step=median(eager_ms), call_ms=call_ms,
            replay_device_ms_per_micro_step=sum(replay_ms) / SCAN_K,
            busy_share=sum(replay_ms) / SCAN_K / steady,
            host_all_reduce_ms=list(graphs.reduce_ms or []), captures=graphs.captures,
            capture_s=graphs.capture_seconds, pool_gib=graphs.pool_bytes() / 2**30,
            gradient_bytes=4 * sum(p.numel() for p in states[1].params.values()),
            loss=float(got["train/loss"][-1]))
        if not all(all(e.values()) for e in line["bit_equal_per_call"]):
            line["failed"].append(f"not bit-equal to the eager mesh micro-steps: "
                                  f"{line['bit_equal_per_call']}")
        if not all(line["metrics_bit_equal_per_call"]):
            line["failed"].append("metrics not bit-equal to the eager mesh micro-steps")
        if no_mesh and not (all(line["bit_equal_to_no_mesh"].values())
                            and line["metrics_bit_equal_to_no_mesh"]):
            line["failed"].append(f"not bit-equal to the scan without a mesh: "
                                  f"{line['bit_equal_to_no_mesh']}")
        if counts != line["expected_launches"]:
            line["failed"].append(f"launches {counts} != {line['expected_launches']}")
        return line, states[1], trainers

    # ---- two gloo ranks, depth [1,1], one sample a rank, the split graphs
    init_distributed(coordinator_address=f"localhost:{plan['port']}", num_processes=2,
                     process_id=rank, backend="gloo", device=device, timeout=120.0)
    mesh = make_mesh()
    stage("joined")
    cfg1 = load_config(prediff_default_config, os.path.join(root, "cfg1.yaml"))
    per1 = per_micro(plan["per1"])
    line, state, trainers = run(cfg1, weights["depth1"], mesh, mesh.size,
                                slice(rank, rank + 1), SCAN_MESH_CALLS, per1)
    digests = gather_parts(bit_digest(state.tensors()).to(device), mesh)
    line["ranks_bit_equal"] = all(torch.equal(digests[0], d) for d in digests[1:])
    if not line["ranks_bit_equal"]:
        line["failed"].append("the ranks' states differ after the calls")
    want_split = {"grads": per1, "accumulate": {}, "update": {}}
    if not line["split"] or line["launches_per_replay"] != want_split:
        line["failed"].append(f"split graphs {line['split']}, launches per replay "
                              f"{line['launches_per_replay']} != {want_split}")
    out["scan_mesh_gloo"] = line
    del state, trainers
    stage("gloo_done")
    dist.barrier()
    dist.destroy_process_group()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    if rank == 0:   # one NCCL rank at full depth: the all-reduce inside the graph
        init_distributed(coordinator_address=f"localhost:{plan['port2']}", num_processes=1,
                         process_id=0, backend=plan["nccl_backend"], device=device,
                         timeout=120.0)
        cfg = load_config(prediff_default_config, os.path.join(root, "cfg.yaml"))
        per = per_micro(plan["per"])
        captured = []
        all_reduce = dist.all_reduce

        def counted(*args, **kwargs):
            if device.type == "cuda":
                captured.append(torch.cuda.is_current_stream_capturing())
            return all_reduce(*args, **kwargs)

        dist.all_reduce = counted
        try:
            line, state, trainers = run(cfg, weights["full"], make_mesh(),
                                        cfg.optim.micro_batch_size, slice(None),
                                        SCAN_MESH_CALLS, per, no_mesh=True)
        finally:
            dist.all_reduce = all_reduce
        line["all_reduces_captured"] = sum(captured)
        want_whole = {"accumulate": per, "update": per}
        if line["split"] or line["launches_per_replay"] != want_whole:
            line["failed"].append(f"split {line['split']}, launches per replay "
                                  f"{line['launches_per_replay']} != {want_whole}")
        if device.type == "cuda" and line["all_reduces_captured"] != 4:
            line["failed"].append(f"{line['all_reduces_captured']} all-reduces captured, not "
                                  "the gradients' and the losses' in each of two graphs")
        out["scan_mesh_nccl"] = line
        del state, trainers
        dist.destroy_process_group()
        stage("nccl_done")
    with open(os.path.join(root, f"scan{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def scan_phases(device, smi, cfg, weights, by_route, cases, zero_counts, read_counts):
    """The dropout kernels' device-seed form (``devseed_kernels_vs_plain``),
    then ``train_scan`` and ``scan_optins``.  Returns the device-seed cases and
    the launches of the ``train_scan`` path by their names."""
    scases, bad = check_devseed_kernels(cases, device)
    emit({"phase": "devseed_kernels_vs_plain", "cases": sum(len(v) for v in scases.values()),
          "failed": len(bad), "bases": list(DROP_BASES),
          "device_ms": {k: [c["device_ms"] for c in cs] for k, cs in scases.items()},
          "int_seed_device_ms": {k: [c["int_seed_device_ms"] for c in cs]
                                 for k, cs in scases.items()}})
    if bad:
        fail(f"device-seed dropout kernel disagrees: {[(n, c.get('shape')) for n, c in bad]}")
    per_train = {k: v["per_train"] for k, v in by_route.items()}
    launches = train_scan(device, smi, cfg, weights, per_train, zero_counts, read_counts)
    remat = scan_optins(device, smi, cfg, weights, per_train, zero_counts, read_counts)
    return scases, {"train_scan": {k: launches.get(v, 0) for k, v in SCAN_FORMS.items()},
                    "scan_optins_remat": {k: remat.get(v, 0) for k, v in SCAN_FORMS.items()}}


def scan_alone(device, smi, depth=None):
    """``--only scan``: the seeded randomized models as ``run`` makes them,
    the kernel cases, then ``scan_mesh_phases`` and ``scan_phases``
    (``depth``: the UNet cut to it)."""
    import torch
    from prediff_torch.config import alignment_default_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    zero_counts, read_counts = kernel_counters()
    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    align_cpu = init_params_(build_alignment_model(cfg), gen,
                             randomize=True).eval().requires_grad_(False)
    cases = kernel_cases(unet_cpu, align_cpu, cfg.optim.micro_batch_size,
                         alignment_default_config().optim.micro_batch_size)
    by_route = path_launches(unet_cpu, align_cpu)
    weights = {"unet": unet_cpu.state_dict(), "vae": vae_cpu.state_dict()}
    scan_mesh_phases(device, smi, cfg, weights, by_route)
    if depth is not None:
        cfg1, weights1, per1 = depth1_unet(cfg, weights["vae"])
        by_route = {k: dict(v, per_train=per1.get(k, 0)) for k, v in by_route.items()}
        cfg, weights = cfg1, weights1
    scases, launches = scan_phases(device, smi, cfg, weights, by_route, cases, zero_counts,
                                   read_counts)
    emit({"kernels": summarize(scases, launches)})


def profiling_helpers(device, smi, cfg, predictor, by_route, avg_d, zero_counts, read_counts):
    """``profiling_helpers``: ``count_kernel_launches`` of one eval-mode UNet
    forward at B=1 against ``path_launches`` (every call launched, the
    wrappers' own counts alike); a ``trace`` of one guided step holding an
    ``annotate`` range and the kernels of the groupnorm, ffn, attention and
    resblock sources; ``StepTimer(device=)`` over ``STEP_TIMER_CALLS`` UNet
    forwards against CUDA events around the same calls."""
    import re

    import torch
    from prediff_torch.ops import _build
    from prediff_torch.utils.profiling import (TPU_KERNELS, StepTimer, annotate,
                                               count_kernel_launches, trace)

    d = cfg.model.diffusion
    rs = torch.Generator().manual_seed(SEED + 30)
    x = torch.randn((1,) + tuple(d.latent_shape), generator=rs).to(device)
    cond = torch.randn((1,) + tuple(d.latent_cond_shape), generator=rs).to(device)
    t = torch.tensor([d.timesteps // 2], device=device)
    unet = predictor.ld.unet
    want, want_wrappers = {}, {}
    for name, per in by_route.items():
        if per["per_unet"]:
            tpu = TPU_KERNELS[COUNTERS[name].__name__]
            want[tpu] = want.get(tpu, 0) + per["per_unet"]
            want_wrappers[name] = per["per_unet"]
    zero_counts()
    with torch.no_grad():
        got = count_kernel_launches(unet, x, t, cond)
    sync(device)
    wrappers = {k: v for k, v in read_counts().items() if v}

    # the trace of one guided step
    zc = predictor.ld.cond_stage_forward(torch.rand(
        (1, cfg.layout.in_len, cfg.layout.img_height, cfg.layout.img_width,
         cfg.layout.data_channels), generator=rs).to(device))
    step = guided_step(predictor.ld, torch.randn((1,) + tuple(d.latent_shape), generator=rs)
                       .to(device), zc, avg_d)
    step()
    sync(device)
    kernels = {}
    for src in ("groupnorm", "ffn", "attention", "resblock"):
        text = (_build.CSRC / f"{src}.cu").read_text()
        kernels[src] = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", text))
    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            with annotate("prediff_guided_step"):
                step()
            sync(device)
        files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        events = json.load(open(os.path.join(log_dir, files[0])))["traceEvents"] if files else []
        trace_bytes = sum(os.path.getsize(os.path.join(log_dir, f)) for f in files)
    names = [e.get("name", "") for e in events]
    kernel_events = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {src: sum(any(k in n for k in ks) for n in kernel_events)
             for src, ks in kernels.items()}

    # StepTimer against CUDA events around the same calls
    timer = StepTimer(device=device)
    event_ms = []
    with torch.no_grad():
        unet(x, t, cond)
        for _ in range(STEP_TIMER_CALLS):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with timer:
                start.record()
                unet(x, t, cond)
                stop.record()
            event_ms.append(start.elapsed_time(stop))
    summary = timer.summary()
    rel = abs(1e3 * summary["mean_s"] - sum(event_ms) / len(event_ms)) / (
        sum(event_ms) / len(event_ms))
    emit({"phase": "profiling_helpers", "count_kernel_launches": got, "expected": want,
          "wrapper_launches": wrappers, "trace_files": len(files), "trace_bytes": trace_bytes,
          "annotate_found": "prediff_guided_step" in names, "kernel_events": len(kernel_events),
          "kernel_events_by_source": found, "step_timer": summary, "event_ms": event_ms,
          "step_timer_vs_events_rel": rel, "tol_rel": STEP_TIMER_TOL_REL, "card": smi})
    if got != want or wrappers != want_wrappers:
        fail(f"profiling_helpers: count_kernel_launches {got} (wrappers {wrappers}) != "
             f"path_launches {want} ({want_wrappers})")
    if len(files) != 1 or "prediff_guided_step" not in names or not all(found.values()):
        fail(f"profiling_helpers: trace files {files}, annotate range found "
             f"{'prediff_guided_step' in names}, kernels by source {found}")
    if rel > STEP_TIMER_TOL_REL:
        fail(f"profiling_helpers: StepTimer mean {summary['mean_s']} s against CUDA events "
             f"{event_ms} ms: {rel} apart")


def optins_alone(device, smi):
    """``--only optins``: ``profiling_helpers`` on the seeded randomized models
    as ``run`` makes them (a predictor with the alignment net), then the
    opt-in phases on the training pipeline as ``train_phases`` builds it (the
    seeded v1 initialisation at full depth, the recipe's rates)."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import (build_alignment_model, build_training_pipeline, build_unet,
                                       build_vae)
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    cfg = prediff_default_config()
    zero_counts, read_counts = kernel_counters()
    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    align_cpu = init_params_(build_alignment_model(cfg), gen,
                             randomize=True).eval().requires_grad_(False)
    weights = {"unet": unet_cpu.state_dict(), "vae": vae_cpu.state_dict(),
               "align": align_cpu.state_dict()}
    by_route = path_launches(unet_cpu, align_cpu)
    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device)
    profiling_helpers(device, smi, cfg, predictor, by_route,
                      torch.tensor([[AVG_X_GT]], device=device), zero_counts, read_counts)
    del predictor
    ld = build_training_pipeline(cfg, device=device, params={"unet": weights["unet"],
                                                              "vae": weights["vae"]})
    L = cfg.layout
    batch = torch.from_numpy(next(synthetic_batch_iterator(
        cfg.optim.micro_batch_size, L.in_len + L.out_len, L.img_height, L.img_width, seed=SEED)))
    xy = (batch[:, L.in_len:].to(device), batch[:, :L.in_len].to(device))
    init_params_(ld.unet, torch.Generator().manual_seed(SEED))
    per_micro = expected_train_launches({k: v["per_train"] for k, v in by_route.items()}, 1, 0,
                                        dropout=True)
    optin_phases(device, cfg, smi, ld, xy, per_micro, zero_counts, read_counts)


# --------------------------------------------------------------------------- #
GUIDED_REPEAT_STEPS = 3


def guided_repeat(device):
    """Whether a guided forecast repeats bit for bit: ``configs/tiny_smoke.yaml``
    at base_units 128 (widths the FFN, attention and resblock kernels take),
    randomized weights, a 3-step guided DDPM forecast through
    ``PreDiffPredictor.predict``: two eager chains, then the captured chain
    three times (one capture, two replays), all bit-equal, and two guidance
    shifts bit-equal, under cuDNN's deterministic algorithms, which the
    card's entry points set before anything is captured
    (``utils.device.resolve_device``).  Also lists the cuDNN input-gradient
    kernels one shift launches (by the profiler)."""
    import torch
    from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor
    from torch.profiler import ProfilerActivity, profile as torch_profile

    cfg = load_config(prediff_default_config,
                      os.path.join(os.path.dirname(os.path.abspath(__file__)), TINY_CONFIG))
    cfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"base_units": 128}, "align": {"model_args": {"base_units": 128}}}}))
    gen = torch.Generator().manual_seed(SEED)
    params = {key: init_params_(build(cfg), gen, randomize=True).state_dict()
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    p = PreDiffPredictor(cfg, params=params, with_alignment=True, device=device)
    L = cfg.layout
    y = torch.rand((1, L.in_len, L.img_height, L.img_width, L.data_channels),
                   generator=torch.Generator().manual_seed(SEED + 2))
    kw = dict(timesteps=GUIDED_REPEAT_STEPS, use_alignment=True, avg_x_gt=[[0.4]])

    def forecast():
        return p.predict(y, generator=torch.Generator(device).manual_seed(SEED + 5), **kw)

    with p.ld._plain_chain():
        eager = [forecast(), forecast()]
    captures = p.ld.graphs.captures
    graph = [forecast() for _ in range(3)]
    captured = p.ld.graphs.captures - captures
    z = torch.randn((1,) + p.ld.latent_shape, device=device,
                    generator=torch.Generator(device).manual_seed(SEED + 6))
    t, avg = torch.tensor([1], device=device), torch.tensor([[0.4]], device=device)
    shifts = [p.ld.alignment.get_mean_shift(z, t, avg) for _ in range(2)]
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        p.ld.alignment.get_mean_shift(z, t, avg)
        torch.cuda.synchronize()
    dgrad = sorted({e.key[:80] for e in prof.key_averages() if "dgrad" in e.key})
    line = {"phase": "guided_repeat", "steps": GUIDED_REPEAT_STEPS, "base_units": 128,
            "cudnn_deterministic": torch.backends.cudnn.deterministic,
            "cudnn_benchmark": torch.backends.cudnn.benchmark, "captures": captured,
            "eager_equals_eager": torch.equal(eager[0], eager[1]),
            "graphs_equal_eager": [torch.equal(g, eager[0]) for g in graph],
            "shift_equals_shift": torch.equal(shifts[0], shifts[1]),
            "eager_max_abs_diff": float((eager[0] - eager[1]).abs().max()),
            "finite": bool(torch.isfinite(eager[0]).all()), "dgrad_kernels": dgrad}
    emit(line)
    if not (line["eager_equals_eager"] and all(line["graphs_equal_eager"])
            and line["shift_equals_shift"] and line["finite"] and captured > 0):
        fail("guided_repeat: two guided forecasts from one seed differ (eager, or captured "
             "against eager), a guidance shift does not repeat, or nothing was captured")


def determinism_cost(fns):
    """Eager ms per call of each of ``fns`` with cuDNN's default algorithms
    (its heuristics: ``deterministic`` and ``benchmark`` off) and with its
    deterministic ones, in turns off, on, on, off; the switch is left on."""
    import torch
    from prediff_torch.utils.device import set_deterministic

    out = {}
    for name, fn in fns.items():
        ms = {False: [], True: []}
        for det in (False, True, True, False):
            torch.backends.cudnn.deterministic = det
            ms[det].append(time_ms(fn, warmup=2, iters=10))
        out[name] = {"default_ms": ms[False], "deterministic_ms": ms[True],
                     "ratio": sum(ms[True]) / sum(ms[False])}
    set_deterministic()
    return {"phase": "determinism_cost", "eager": out}


VAE_TRAIN_STEPS = 3
VAE_LOSS_TOL_REL = 1e-4       # card vs CPU, f32 convolutions (TF32 off) on both sides
VAE_GRAD_TOL_REL_L2 = 1e-3
VAE_GRAD_MIN_COSINE = 0.999


def vae_train_phases(device, smi):
    """The VAE-GAN trainer of ``vae_training_default_config()`` (the v1 VAE
    and discriminator, seeded initialisation) from
    ``factory.build_vae_trainer`` on synthetic 128x128 frames.
    ``vae_train_grads``: one step's losses and both states' gradients at B=1
    and ``disc_start`` 0, card against CPU with the same posterior noise,
    then twice on the card at the micro-batch for bit-equal gradients and
    logs.  ``vae_train``: ``VAE_TRAIN_STEPS`` steps at the micro-batch, once
    at the recipe's ``disc_start`` and once at 0 (the GAN terms carry
    gradient), each with ``train/rec_loss`` of the batch with fixed posterior
    noise before and after (it must fall), ms per step and frames/s; a
    profile of one step.  No hand-written kernel runs here: the VAE and the
    discriminator are cuDNN's convolutions."""
    import numpy as np
    import torch
    from prediff_torch.config import vae_training_default_config
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_discriminator, build_vae, build_vae_trainer
    from prediff_torch.models.init import init_params_

    cfg = vae_training_default_config()
    B, H, W = cfg.optim.micro_batch_size, cfg.layout.img_height, cfg.layout.img_width
    gen = torch.Generator().manual_seed(SEED)
    weights = {"vae": init_params_(build_vae(cfg), gen).state_dict(),
               "disc": build_discriminator(cfg).reset_parameters(gen).state_dict()}
    frames = torch.from_numpy(next(synthetic_batch_iterator(B, 1, H, W, seed=SEED + 4))[:, 0])
    down = 2 ** (len(cfg.model.vae.block_out_channels) - 1)   # the encoder's downsampling
    eps = torch.randn((B, H // down, W // down, cfg.model.vae.latent_channels),
                      generator=torch.Generator().manual_seed(SEED + 5))

    def trainer_on(dev, disc_start):
        trainer = build_vae_trainer(cfg, device=dev, params=weights, seed=SEED)
        trainer.disc_start = disc_start
        return trainer, trainer.create_states()

    def fixed_noise(trainer, noise):
        """The trainer's posterior sample with ``noise`` in place of its draw."""
        def reconstruct(x, generator):
            posterior = trainer.vae.encode(x)
            recon, feats = trainer.vae.decode_with_features(
                posterior.mean + posterior.std * noise.to(x.device))
            return recon, feats, posterior
        trainer._reconstruct = reconstruct

    # one step at B=1, card against CPU, the GAN terms on
    t1 = time.perf_counter()
    out = {}
    for dev in ("cpu", device):
        trainer, (g_state, d_state, _) = trainer_on(dev, 0)
        fixed_noise(trainer, eps[:1])
        g, d, logs = trainer.grads(g_state, d_state, SEED, frames[:1].to(dev))
        out[str(dev)] = (g, d, {k: float(v) for k, v in logs.items()})
        if dev == "cpu":
            cpu_s = time.perf_counter() - t1
        del trainer, g_state, d_state
    (g_cpu, d_cpu, logs_cpu), (g_card, d_card, logs_card) = out["cpu"], out[str(device)]
    loss_rel = {k: abs(logs_card[k] - logs_cpu[k]) / abs(logs_cpu[k])
                for k in ("train/total_loss", "train/disc_loss", "train/nll_loss",
                          "train/g_loss", "train/d_weight")}
    gen_err, disc_err = rel_l2_and_cosine(g_card, g_cpu), rel_l2_and_cosine(d_card, d_cpu)
    finite = all(torch.isfinite(t).all() for t in (*g_card, *d_card))
    # twice on the card at the micro-batch
    trainer, (g_state, d_state, _) = trainer_on(device, 0)
    x = frames.to(device)
    a = trainer.grads(g_state, d_state, SEED, x)
    b = trainer.grads(g_state, d_state, SEED, x)
    bit_equal = (all(torch.equal(u, v) for u, v in zip((*a[0], *a[1]), (*b[0], *b[1])))
                 and all(torch.equal(a[2][k], b[2][k]) for k in a[2]))
    del trainer, g_state, d_state, a, b
    emit({"phase": "vae_train_grads", "batch_cpu": 1, "batch_card": B, "frames": [H, W],
          "disc_start": 0, "logs_card": logs_card, "logs_cpu": logs_cpu,
          "loss_rel_err": loss_rel, "tol_loss_rel": VAE_LOSS_TOL_REL,
          "gen_grad_rel_l2_err": gen_err[0], "gen_grad_cosine": gen_err[1],
          "disc_grad_rel_l2_err": disc_err[0], "disc_grad_cosine": disc_err[1],
          "tol_rel_l2": VAE_GRAD_TOL_REL_L2, "min_cosine": VAE_GRAD_MIN_COSINE,
          "gen_leaves": len(g_card), "disc_leaves": len(d_card),
          "bit_equal_across_two_runs": bit_equal, "cpu_step_s": cpu_s})
    if not finite:
        fail("vae_train_grads: non-finite gradient on the card")
    if (max(loss_rel.values()) > VAE_LOSS_TOL_REL
            or max(gen_err[0], disc_err[0]) > VAE_GRAD_TOL_REL_L2
            or min(gen_err[1], disc_err[1]) < VAE_GRAD_MIN_COSINE):
        fail(f"vae_train_grads: card differs from the CPU: losses {loss_rel}, generator "
             f"gradient {gen_err}, discriminator gradient {disc_err}")
    if not bit_equal:
        fail("vae_train_grads: two runs of the same step on the card differ")

    for disc_start in (cfg.model.loss.disc_start, 0):
        trainer, (g_state, d_state, stats) = trainer_on(device, disc_start)

        @torch.no_grad()
        def rec_loss():
            posterior = trainer.vae.encode(x)
            recon = trainer.vae.decode(posterior.mean + posterior.std * eps.to(device))
            return float((x - recon).abs().mean())

        before = rec_loss()
        torch.cuda.reset_peak_memory_stats(device)
        steps = []
        for _ in range(VAE_TRAIN_STEPS):
            sync(device)
            t0 = time.perf_counter()
            g_state, d_state, stats, logs = trainer.train_step(g_state, d_state, stats, SEED, x)
            sync(device)
            steps.append({"ms": 1e3 * (time.perf_counter() - t0),
                          **{k.split("/")[1]: float(v) for k, v in logs.items()}})
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        after = rec_loss()
        steady = sorted(st["ms"] for st in steps[1:])
        ms = steady[len(steady) // 2]
        PHASE_NUMBERS[("vae_train", disc_start)] = {"ms_per_step": ms,
                                                     "frames_per_s": 1e3 * B / ms, "peak": peak}
        emit({"phase": "vae_train", "batch": B, "frames": [H, W], "disc_start": disc_start,
              "steps": steps, "ms_per_step": ms, "frames_per_s": 1e3 * B / ms,
              "fixed_draw_rec_loss_before": before, "fixed_draw_rec_loss_after": after,
              "running_var_mean": {k: float(v.mean()) for k, v in stats.items()},
              "peak_mem_gib": peak, "card": smi})
        if g_state.step != VAE_TRAIN_STEPS or d_state.tx.count != VAE_TRAIN_STEPS:
            fail(f"vae_train: {g_state.step} generator steps, {d_state.tx.count} "
                 "discriminator updates")
        if not all(np.isfinite(v) for st in steps for v in st.values()):
            fail("vae_train: non-finite loss or log")
        if not after < before:
            fail(f"vae_train (disc_start {disc_start}): rec_loss did not fall: {before} -> "
                 f"{after} (same batch, same posterior noise)")
        if disc_start == 0:
            emit(profile("profile_vae_train_step",
                         lambda: trainer.train_step(g_state, d_state, stats, SEED, x), reps=2))
        del trainer, g_state, d_state, stats


# card vs CPU: the alignment net's prediction within the UNet forward's bar; its
# MSE loss within LOSS_TOL_REL or, where larger, what that prediction error
# allows (a small residual makes the loss sensitive: 2e + e^2 for an error e
# of the residual's norm)
ALIGN_PRED_TOL_REL_L2 = 2e-2
ALIGN_FIXED_DRAWS = 4    # draws (posterior sample, t, noise) of align_train's fixed-batch loss


def align_train_launches(per, micro_steps: int, dropout: bool):
    """Launches of ``micro_steps`` alignment training micro-steps from each
    kernel's ``per_align_train`` (the recipe's rates); without ``dropout``
    (rates 0) the FFN and attention kernels without dropout take the
    dropout forms' launches."""
    out = {name: micro_steps * v["per_align_train"] for name, v in per.items()}
    if not dropout:
        for plain, drop in PAIRS:
            out[plain], out[drop] = out[drop], 0
    return out


def align_train_phases(device, smi, per, zero_counts, read_counts):
    """The alignment trainer of ``alignment_default_config()`` (the v1
    alignment net, axial, with the frozen v1 VAE) from
    ``factory.build_alignment_trainer`` at the micro-batch.
    ``align_train_grads`` at rates 0 and at the recipe's 0.1: one loss and
    backward from fixed latents, t and noise (``AlignmentTrainer.p_losses``),
    card (kernels) against CPU (plain, f32, the same Philox masks), with
    randomized weights: the prediction (``ALIGN_PRED_TOL_REL_L2``), the loss
    and every gradient; twice on the card for bit-equal gradients, with the
    exact launch counts.  ``align_train``: ``TRAIN_OPT_STEPS`` micro-steps of
    ``train_step`` on synthetic pixel windows (the VAE encode included) from
    the same randomized weights at the recipe's rates and schedule, each with the exact
    launches (GN+SiLU and its all-gradients backward in ``first_proj``, the
    resblock kernels, the FFN and axial attention dropout kernels, nothing
    else), ms per micro-step, samples/s, the loss of the batch at rates 0
    (eval mode), the mean over ``ALIGN_FIXED_DRAWS`` fixed draws, before and
    after (it must fall; AdamW's first steps move every weight by about lr,
    and a loss of ~0.05 falls at the recipe's 1e-5 but overshoots on a
    100-step schedule, whose third step takes 2.8e-5); a profile of one
    micro-step.  ``per`` is ``path_launches``' count of each kernel
    for the v1 networks.  Returns the launches of ``align_train``."""
    import numpy as np
    import torch
    from prediff_torch.config import ConfigDict, alignment_default_config, deep_merge
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_alignment_model, build_alignment_trainer, build_vae
    from prediff_torch.models.init import init_params_

    cfg = alignment_default_config()
    a, d, L = cfg.model.align.model_args, cfg.model.diffusion, cfg.layout
    B = cfg.optim.micro_batch_size
    if not (a.attn_drop > 0 and a.proj_drop > 0 and a.ffn_drop > 0):
        fail(f"align_train: the configuration's dropout rates are not the recipe's ({a})")

    def with_rates(rate):
        return ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"align": {"model_args": dict(
            attn_drop=rate, proj_drop=rate, ffn_drop=rate)}}}))

    gen = torch.Generator().manual_seed(SEED)
    vae_sd = init_params_(build_vae(cfg), gen).state_dict()
    random_sd = init_params_(build_alignment_model(cfg), gen, randomize=True).state_dict()
    rs = torch.Generator().manual_seed(SEED + 7)
    z = torch.randn((B,) + tuple(a.input_shape), generator=rs)
    t = torch.randint(0, d.timesteps, (B,), generator=rs)
    noise = torch.randn(z.shape, generator=rs)
    target = torch.rand((B, a.out_len, 1), generator=rs)

    def loss_and_grads(trainer, state, dropout_seed):
        """The loss, every gradient and the network's prediction."""
        dev = trainer.device
        preds = []
        hook = trainer.model.register_forward_hook(lambda m, i, o: preds.append(o.detach()))
        try:
            loss, _ = trainer.p_losses(z.to(dev), t.to(dev), noise.to(dev), target.to(dev),
                                       dropout_seed)
        finally:
            hook.remove()
        return (float(loss.detach()), torch.autograd.grad(loss, list(state.params.values())),
                preds[0].cpu())

    for rate in (0.0, a.attn_drop):
        c = with_rates(rate)
        params = {"vae": vae_sd, "align": random_sd}
        t1 = time.perf_counter()
        cpu = build_alignment_trainer(c, device="cpu", params=params, seed=SEED)
        loss_cpu, grads_cpu, pred_cpu = loss_and_grads(cpu, cpu.create_state(), DROP_SEED)
        cpu_s = time.perf_counter() - t1
        card = build_alignment_trainer(c, device=device, params=params, seed=SEED)
        state = card.create_state()
        loss_and_grads(card, state, DROP_SEED)    # warm-up: cuDNN picks its algorithms
        sync(device)
        zero_counts()
        loss_card, grads_card, pred_card = loss_and_grads(card, state, DROP_SEED)
        sync(device)
        counts = read_counts()
        _, grads_again, _ = loss_and_grads(card, state, DROP_SEED)
        want_counts = align_train_launches(per, 1, dropout=rate > 0)
        rel_l2, cosine = rel_l2_and_cosine(grads_card, grads_cpu)
        leaf_rel = [float((u.cpu() - v).norm() / v.norm().clamp_min(1e-30))
                    for u, v in zip(grads_card, grads_cpu)]
        worst = int(np.argmax(leaf_rel))
        names = list(state.params)
        bit_equal = all(torch.equal(u, v) for u, v in zip(grads_card, grads_again))
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        # the regression loss mean((pred - target)^2) moves by at most 2e + e^2 of
        # itself when the prediction moves by e of the residual's norm (Cauchy-Schwarz)
        pred_err = float((pred_card - pred_cpu).norm() / pred_cpu.norm())
        e = float((pred_card - pred_cpu).norm() / (pred_cpu - target).norm())
        loss_tol = max(LOSS_TOL_REL, 2 * e + e * e + 1e-6)
        emit({"phase": "align_train_grads", "batch": B, "rate": rate,
              "dropout_seed": DROP_SEED, "leaves": len(names), "loss_card": loss_card,
              "loss_cpu": loss_cpu, "loss_rel_err": loss_rel, "tol_loss_rel": loss_tol,
              "pred_rel_l2_err": pred_err, "tol_pred_rel_l2": ALIGN_PRED_TOL_REL_L2,
              "pred_err_of_residual": e,
              "grad_rel_l2_err": rel_l2, "grad_cosine": cosine, "tol_rel_l2": GRAD_TOL_REL_L2,
              "min_cosine": GRAD_MIN_COSINE, "worst_leaf": names[worst],
              "worst_leaf_rel_l2": leaf_rel[worst],
              "bit_equal_across_two_runs": bit_equal, "launches": counts,
              "expected_launches": want_counts, "cpu_loss_and_backward_s": cpu_s})
        if not all(torch.isfinite(g).all() for g in grads_card):
            fail("align_train_grads: non-finite gradient on the card")
        if (pred_err > ALIGN_PRED_TOL_REL_L2 or loss_rel > loss_tol or rel_l2 > GRAD_TOL_REL_L2
                or cosine < GRAD_MIN_COSINE):
            fail(f"align_train_grads (rate {rate}): card differs from the CPU: prediction "
                 f"{pred_err}, loss {loss_rel} (bar {loss_tol}), gradient rel_l2 {rel_l2}, "
                 f"cosine {cosine}")
        if not bit_equal:
            fail(f"align_train_grads (rate {rate}): two runs on the card differ")
        if counts != want_counts:
            fail(f"align_train_grads (rate {rate}): kernel launches {counts} != {want_counts}")
        del cpu, card, state

    # train_step at the recipe's rates and schedule (30000 steps: a 3000-step warmup
    # from lr 1e-5, as scripts/train_sevirlr_avg_x.py runs it)
    trainer = build_alignment_trainer(cfg, device=device,
                                      params={"vae": vae_sd, "align": random_sd}, seed=SEED)
    state = trainer.create_state()
    batch = torch.from_numpy(next(synthetic_batch_iterator(
        B, L.in_len + L.out_len, L.img_height, L.img_width, seed=SEED + 8)))
    x, y = batch[:, L.in_len:].to(device), batch[:, :L.in_len].to(device)

    @torch.no_grad()
    def fixed_loss():
        """The eval-mode loss of the batch, the mean over ALIGN_FIXED_DRAWS fixed draws."""
        trainer.model.eval()
        try:
            losses = [trainer.loss_fn(torch.Generator(device).manual_seed(SEED + k), x, y)[0]
                      for k in range(ALIGN_FIXED_DRAWS)]
            return float(sum(losses)) / ALIGN_FIXED_DRAWS
        finally:
            trainer.model.train()

    before = fixed_loss()
    per_micro = align_train_launches(per, 1, dropout=True)
    micro = []
    torch.cuda.reset_peak_memory_stats(device)
    zero_counts()
    for _ in range(TRAIN_OPT_STEPS):
        sync(device)
        was = read_counts()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, SEED, x, y)
        sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        now = read_counts()
        micro.append({"ms": ms, **{k: float(v) for k, v in metrics.items()},
                      "launches": {k: now[k] - was[k] for k in now}})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    after = fixed_loss()
    expected = align_train_launches(per, TRAIN_OPT_STEPS, dropout=True)
    steady = sorted(m["ms"] for m in micro[1:])
    ms = steady[len(steady) // 2]
    PHASE_NUMBERS["align_train"] = ms
    emit({"phase": "align_train", "batch": B, "rates": {k: a[k] for k in
                                                         ("attn_drop", "proj_drop", "ffn_drop")},
          "optimizer_steps": state.tx.count, "micro": micro, "ms_per_micro_step": ms,
          "samples_per_s": 1e3 * B / ms, "fixed_draw_loss_before": before,
          "fixed_draw_loss_after": after, "peak_mem_gib": peak, "launches": launches,
          "expected_launches": expected, "launches_per_micro_step": per_micro, "card": smi})
    if state.tx.count != TRAIN_OPT_STEPS:
        fail(f"align_train: {state.tx.count} optimizer steps")
    if not all(np.isfinite(m["train_loss"]) for m in micro):
        fail("align_train: non-finite loss")
    if not after < before:
        fail(f"align_train: the loss did not fall: {before} -> {after} (same batch and draws)")
    if any(m["launches"] != per_micro for m in micro) or launches != expected:
        fail(f"align_train: kernel launches {launches} != expected {expected} "
             f"(per micro-step {[m['launches'] for m in micro]})")
    emit(profile("profile_align_train_step", lambda: trainer.train_step(state, SEED, x, y),
                 reps=2))
    return launches



# --------------------------------------------------------------------------- #
# The command-line programs (prediff_torch/cli) at full width: the cli_* phases
CLI_PHASES = ("cli_sample", "cli_train", "cli_test", "cli_vae", "cli_align", "cli_convert",
              "cli_learning_check")   # each a function of this name
CLI_PACKAGES = ("h5py", "pandas", "matplotlib")   # the programs' data and panels need them
CLI_CONTEXTS = 2          # cli_sample: contexts x members, guided DDIM
CLI_MEMBERS = 2
CLI_DDIM_STEPS = 20       # cli_sample, and cli_train's validation (the recipe's: 50)
CLI_TRAIN_MICRO_STEPS = 6     # at accum 2: three optimizer steps (as `train`), then a validation
CLI_TEST_DDIM_STEPS = 20
CLI_TRAINER_STEPS = 3     # cli_vae, cli_align
CLI_CONVERT_DDIM_STEPS = 10
CLI_TOL_REL = 1e-6        # cli_test: the suites refilled from the .npy dumps; FVD 1e-3
CLI_FVD_TOL_REL = 1e-3
# the kernels each program must launch at the v1 recipe (PERF.md rows 1-4, 6, 7; 1, 14, 15a-15d)
CLI_GUIDED_KERNELS = ("groupnorm_silu", "ffn", "axial_attention", "axial_attention_bwd_dx",
                      "ffn_bwd_dx", "resblock", "resblock_bwd")
CLI_TRAIN_KERNELS = ("groupnorm_silu", "groupnorm_silu_bwd_full", "ffn_dropout",
                     "ffn_dropout_bwd_full", "axial_attention_dropout",
                     "axial_attention_dropout_bwd_full")
CLI_ALIGN_KERNELS = CLI_TRAIN_KERNELS + ("resblock", "resblock_bwd")
# tests/test_cli_smoke.py's test keys of the JAX script
CLI_TEST_SMOKE_KEYS = ("test_csi_avg_epoch", "test_fvd_epoch", "test_aligned_csi_avg_epoch",
                       "test_aligned_fvd_epoch", "test_crps_epoch", "test_ssim_epoch")


class WindowModule:
    """A test double of ``datasets.SEVIRDataModule`` for a host without h5py
    or pandas: seeded synthetic windows (``synthetic_batch_iterator``,
    (B, seq_len, H, W, 1) numpy in [0, 1]) in memory, with the methods and
    the properties the programs' functions below ``main`` read."""

    def __init__(self, batch: int, seq_len: int, size: int, n_train: int, n_val: int = 1,
                 n_test: int = 1, seed: int = SEED):
        from prediff_torch.datasets import synthetic_batch_iterator

        def windows(n, s):
            return list(synthetic_batch_iterator(batch, seq_len, size, size, seed=s,
                                                 num_batches=n))

        self._train = windows(n_train, seed)
        self._val = windows(n_val, seed + 1)
        self._test = windows(n_test, seed + 2)
        self.num_train_samples = n_train * batch
        self.num_val_samples = n_val * batch

    def train_batches(self, epoch_seed: int = 0):
        yield from self._train

    def val_batches(self):
        yield from self._val

    def test_batches(self):
        yield from self._test


def cli_route() -> dict:
    """Which of h5py, pandas and matplotlib import here: with all three the
    programs run whole (``main`` with ``--synthetic``), else their functions
    below ``main`` on ``WindowModule``s."""
    import importlib

    have = {}
    for name in CLI_PACKAGES:
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    return {"packages": have, "route": "main" if all(have.values()) else "functions"}


def plain_spy():
    """``(install, count, remove)``: every plain version of the kernel
    wrappers (``*_plain`` in ``prediff_torch.ops``) wrapped to count its
    calls on CUDA tensors, which no program may make in place of a kernel.
    Calls inside ``ops/_build.plain_grads`` are counted apart
    (``recompute``): the resblock's parameter gradients are autograd of its
    plain version on any device, as the JAX package takes them by
    ``jax.vjp`` of ``resblock_reference`` (``pallas_resblock.py:636-641``)."""
    import importlib

    import torch
    from prediff_torch.ops import _build

    calls, recompute = {}, {}
    saved = []
    depth = [0]

    def wrap(name, fn):
        def spy(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in list(args) + list(kwargs.values())):
                tally = recompute if depth[0] else calls
                tally[name] = tally.get(name, 0) + 1
            return fn(*args, **kwargs)
        return spy

    def in_recompute(fn):
        def marked(*args, **kwargs):
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return marked

    def install():
        calls.clear()
        recompute.clear()
        saved.append((_build, "plain_grads", _build.plain_grads))
        _build.plain_grads = in_recompute(_build.plain_grads)
        for m in ("attention", "conv3d", "ffn", "groupnorm", "resblock"):
            mod = importlib.import_module(f"prediff_torch.ops.{m}")
            for name in dir(mod):
                fn = getattr(mod, name)
                if callable(fn) and not name.startswith("_") and "_plain" in name:
                    saved.append((mod, name, fn))
                    setattr(mod, name, wrap(f"{m}.{name}", fn))

    def remove():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        saved.clear()

    return install, lambda: (dict(calls), dict(recompute)), remove


class timed_method:
    """Times each call of ``cls.name`` (synchronized on both sides) into
    ``self.ms``, with the value of ``state.step`` (the first argument's)
    before the call, for the ``with`` block; restores the method after."""

    def __init__(self, cls, name, device):
        self.cls, self.name, self.device = cls, name, device
        self.ms, self.steps = [], []

    def __enter__(self):
        fn = getattr(self.cls, self.name)
        self.fn = fn

        def timed(obj, state, *args, **kwargs):
            self.steps.append(int(getattr(state, "step", -1)))
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(obj, state, *args, **kwargs)
            sync(self.device)
            self.ms.append(1e3 * (time.perf_counter() - t0))
            return out

        setattr(self.cls, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.fn)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def chain_launches(per, unguided_steps: int = 0, guided_steps: int = 0) -> dict:
    """Launches of reverse chains of ``unguided_steps`` and ``guided_steps``
    steps in all, from ``path_launches``' counts per UNet forward and per
    guidance shift (a chain's launches do not depend on its batch)."""
    return {k: (unguided_steps + guided_steps) * v["per_unet"] + guided_steps * v["per_align"]
            for k, v in per.items()}


def cli_phases(device, smi, weights, per, zero_counts, read_counts, names=None) -> dict:
    """The programs of ``prediff_torch/cli`` at full width on ``device``,
    each with the kernels' launch counts set to 0 just before it and read
    just after the program, before the phase's own checks launch anything
    (a phase calls ``mark()`` where its program ends, else the counts are
    read at its end), a spy on every plain version (no call on the card)
    and its printed lines kept (``stdout_tail``): ``cli_sample``,
    ``cli_train``, ``cli_test``, ``cli_vae``, ``cli_align``, ``cli_convert``
    and ``cli_learning_check`` (``CLI_PHASES``; ``names``: those alone).  A phase whose line has
    ``expected_launches`` is held to them exactly.  ``weights``: the
    randomized v1 state dicts of "unet", "vae" and "align" (the trainers
    start from the seeded initialisation, as a run does); ``per``:
    ``path_launches`` of the v1 UNet and alignment net.  Returns the
    launches by phase."""
    import contextlib
    import io

    route = cli_route()
    emit({"phase": "cli_route", **route})
    install, spied, remove = plain_spy()
    launches = {}
    taken = []

    def mark():
        sync(device)
        if not taken:
            taken.append(read_counts())

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        for phase in CLI_PHASES if names is None else names:
            fn = globals()[phase]
            os.makedirs(os.path.join(root, phase))
            out = io.StringIO()
            install()
            taken.clear()
            try:
                zero_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    line, want = fn(device, route["route"], os.path.join(root, phase), weights,
                                    per, mark)
                sync(device)
                seconds = time.perf_counter() - t0
                counts = taken[0] if taken else read_counts()
            finally:
                remove()
            plain, recompute = spied()
            launches[phase] = counts
            line = {"phase": phase, **line, "seconds": seconds,
                    "launches": {k: v for k, v in counts.items() if v},
                    "plain_calls_on_card": plain,
                    "param_grad_recompute_on_card": recompute, "card": smi,
                    "stdout_tail": out.getvalue().splitlines()[-6:]}
            emit(line)
            if plain:
                fail(f"{phase}: plain versions ran on the card: {plain}")
            missing = [k for k in want if not counts.get(k)]
            if missing:
                fail(f"{phase}: kernels {missing} never launched ({counts})")
            expected = line.get("expected_launches")
            wrong = {k: [n, expected.get(k, 0)] for k, n in counts.items()
                     if expected is not None and n != expected.get(k, 0)}
            if wrong:
                fail(f"{phase}: launches [counted, expected] {wrong}")
            if line.get("failed"):
                fail(f"{phase}: {line['failed']}")
    emit({"phase": "cli_all", "phases": list(launches), "seconds": time.perf_counter() - t_all,
          "card": smi})
    return launches


def cli_chain_timer(ld, device):
    """Wraps ``ld._chain`` to record each chain's step-loop seconds
    (synchronized); returns the list it fills and the undo."""
    loops = []
    chain = ld._chain

    def timed_chain(*args):
        sync(device)
        t0 = time.perf_counter()
        ends = chain(*args)
        sync(device)
        loops.append(time.perf_counter() - t0)
        return ends

    ld._chain = timed_chain
    return loops, lambda: delattr(ld, "_chain")


def cli_sample(device, route, root, weights, per, mark):
    """``sample_prediff``: ``CLI_CONTEXTS`` contexts x ``CLI_MEMBERS``
    members, guided, ``CLI_DDIM_STEPS`` DDIM steps.  Each forecast
    (1, 6, 128, 128, 1), finite, members different, and bit-equal to
    ``LatentDiffusion.sample`` called directly with the generator the
    program derives (``step_generator(seed, c * 997 + i)``); the program's
    launches, read before those direct calls, exactly those of its
    ``CLI_CONTEXTS * CLI_MEMBERS`` guided chains; ms per step of the step
    loop (the captures apart)."""
    import numpy as np
    import torch
    from prediff_torch.cli import sample_prediff
    from prediff_torch.config import prediff_default_config
    from prediff_torch.diffusion.knowledge_alignment import get_alignment_kwargs_avg_x
    from prediff_torch.factory import build_pipeline
    from prediff_torch.training.diffusion_trainer import step_generator

    cfg = prediff_default_config()
    L = cfg.layout
    argv = ["--out", root, "--num-contexts", str(CLI_CONTEXTS), "--num-samples", str(CLI_MEMBERS),
            "--use-alignment", "--ddim-steps", str(CLI_DDIM_STEPS)]
    if route == "main":
        argv.append("--vis")
        args = sample_prediff.parse_args(argv + ["--synthetic"])
        sample_prediff.main(argv + ["--synthetic"])
        mark()
        ld = sample_prediff.build_sampler(cfg, args, device)   # the same seeded weights
        windows = list(sample_prediff.data_module(cfg, args).test_batches())[:CLI_CONTEXTS]
        preds = [[np.load(os.path.join(root, f"ctx{c}_sample{i}.npy"))
                  for i in range(CLI_MEMBERS)] for c in range(CLI_CONTEXTS)]
        loops, undo = cli_chain_timer(ld, device)
        captures = 0.0
    else:
        args = sample_prediff.parse_args(argv)
        ld = build_pipeline(cfg, with_alignment=True, device=device, params=weights)
        windows = WindowModule(1, cfg.dataset.seq_len, L.img_height, 0,
                               n_test=CLI_CONTEXTS).test_batches()
        windows = list(windows)
        loops, undo = cli_chain_timer(ld, device)
        cap0 = ld.graphs.capture_seconds
        preds = sample_prediff.sample_contexts(args, cfg, ld, windows)
        mark()
        captures = ld.graphs.capture_seconds - cap0
    program_loops = list(loops)
    bit_equal, differ, finite, shapes = [], [], [], []
    for c, batch in enumerate(windows):
        b = torch.from_numpy(batch).to(device)
        y, x = b[:, :L.in_len], b[:, L.in_len:L.in_len + L.out_len]
        for i, got in enumerate(preds[c]):
            want = ld.sample(y, use_alignment=True, alignment_kwargs=get_alignment_kwargs_avg_x(x),
                             sampler="ddim", ddim_steps=CLI_DDIM_STEPS, guidance_every_k=1,
                             generator=step_generator(args.seed, c * 997 + i, device))
            bit_equal.append(bool(np.array_equal(got, want.cpu().numpy())))
            finite.append(bool(np.isfinite(got).all()))
            shapes.append(list(got.shape))
        differ.append(not np.array_equal(preds[c][0], preds[c][1]))
    direct_loops = loops[len(program_loops):]
    undo()
    step_ms = [1e3 * s / CLI_DDIM_STEPS for s in program_loops]
    failed = []
    if not all(bit_equal):
        failed.append(f"forecasts differ from ld.sample with the program's generators {bit_equal}")
    if not all(finite) or any(s != [1, L.out_len, L.img_height, L.img_width, 1] for s in shapes):
        failed.append(f"shapes {shapes} or non-finite values")
    if not all(differ):
        failed.append("members of a context are equal")
    return ({"route": route, "contexts": CLI_CONTEXTS, "members": CLI_MEMBERS,
             "ddim_steps": CLI_DDIM_STEPS, "guided": True, "shapes": shapes, "finite": all(finite),
             "members_differ": differ, "bit_equal_to_library_call": bit_equal,
             "program_loop_ms_per_step": step_ms,
             "ms_per_step": median(step_ms[1:]) if route == "functions" else None,
             "capture_s": captures,
             "direct_ms_per_step": [1e3 * s / CLI_DDIM_STEPS for s in direct_loops],
             "expected_launches": chain_launches(
                 per, guided_steps=CLI_CONTEXTS * CLI_MEMBERS * CLI_DDIM_STEPS),
             "failed": failed}, CLI_GUIDED_KERNELS)


def cli_train(device, route, root, weights, per, mark):
    """``train_sevirlr_prediff`` at ``total_batch_size`` 4 (accum 2), the
    UNet cut to depth [1,1]: ``CLI_TRAIN_MICRO_STEPS`` micro-steps through
    ``fit`` and one validation at ``CLI_DDIM_STEPS`` DDIM steps on the
    data-index-0 example (aligned and unaligned suites, the train example);
    ``metrics.jsonl`` holds the JAX script's keys and ``valid_loss_epoch ==
    -valid_csi_avg_epoch``; a resume from ``ckpt_last`` continues at the
    saved step.  Wall ms per micro-step: the median of micro-steps 3-6, the
    upper of the middle two."""
    import numpy as np
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import prediff_default_config
    from prediff_torch.training import DiffusionTrainer
    from prediff_torch.utils.checkpoint import all_steps

    cfg = prediff_default_config()
    cfg.model.latent_model.depth = [1, 1]
    cfg.optim.total_batch_size = 2 * cfg.optim.micro_batch_size
    cfg.eval.val_ddim_steps = CLI_DDIM_STEPS
    n = CLI_TRAIN_MICRO_STEPS
    argv = ["--save", root, "--max-steps", str(n)]
    if route == "main":
        cfg_path = os.path.join(os.path.dirname(root), "cli_train.yaml")
        from prediff_torch.config import save_yaml
        save_yaml(cfg, cfg_path)
        argv += ["--cfg", cfg_path, "--synthetic"]
    argv_resume = ["--save", root, "--max-steps", str(n + 1), "--ckpt-name", "ckpt_last"]
    argv_resume += argv[4:]
    args = tp.parse_args(argv)
    dm = (None if route == "main" else
          WindowModule(cfg.optim.micro_batch_size, cfg.dataset.seq_len, cfg.layout.img_height, n))
    first = None
    with timed_method(DiffusionTrainer, "train_step", device) as steps:
        if route == "main":
            tp.main(argv)
            tp.main(argv_resume)
        else:
            ld = tp.build_models(cfg, args, device)
            state = tp.train(args, cfg, dm, device, root, ld)
            first = [state.step, state.tx.count]
            tp.train(tp.parse_args(argv_resume), cfg, dm, device, root, ld)
    with open(os.path.join(root, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = {k for r in records for k in r}
    # no FVD in validation; CRPS with more than one member
    metric_keys = [k for k in EVAL_KEYS if k != "fvd_epoch"
                   and (k != "crps_epoch" or cfg.eval.num_samples_per_context > 1)]
    want_keys = ({"step", "time", "logvar", "val/loss", "val/loss_gamma", "val/loss_simple",
                  "val/loss_vlb"} | {f"{p}_{k}" for p in ("valid", "valid_aligned")
                                     for k in metric_keys})
    val = [r for r in records if "valid_loss_epoch" in r]
    failed = []
    if keys != want_keys:
        failed.append(f"metrics keys {sorted(keys ^ want_keys)} differ from the JAX script's")
    if not val or any(r["valid_loss_epoch"] != -r["valid_csi_avg_epoch"] for r in val):
        failed.append("valid_loss_epoch != -valid_csi_avg_epoch")
    if not all(np.isfinite(v) for r in records for v in r.values()):
        failed.append("non-finite metric")
    if [r["step"] for r in val] != [n, n + 1]:
        failed.append(f"validations at steps {[r['step'] for r in val]}")
    if steps.steps != list(range(n)) + [n]:
        failed.append(f"micro-steps started at {steps.steps}: the resume did not continue at {n}")
    saved = all_steps(os.path.join(root, "ckpt_last"))
    if saved != [n, n + 1]:
        failed.append(f"ckpt_last steps {saved}")
    if first not in (None, [n, n // tp.accum_steps(cfg)]):
        failed.append(f"(micro-steps, optimizer steps) {first} after the first run")
    return ({"route": route, "depth": list(cfg.model.latent_model.depth), "micro_steps": n,
             "accum_steps": tp.accum_steps(cfg),
             "micro_step_ms": steps.ms, "ms_per_micro_step": median(steps.ms[2:n]),
             "steps_after_first_run": first,
             "resumed_at_step": steps.steps[n:],
             "ckpt_last_steps": saved, "val_records": len(val),
             "val_loss": [r["val/loss"] for r in val],
             "valid_csi_avg_epoch": [r["valid_csi_avg_epoch"] for r in val],
             "keys_equal_jax_script": keys == want_keys, "failed": failed}, CLI_TRAIN_KERNELS)


def cli_test(device, route, root, weights, per, mark):
    """``train_sevirlr_prediff --test --num-samples 2 --ddim-steps 20``
    (``run_eval``) on one test batch of 2 windows, FVD over
    ``seeded_i3d(400)`` at 224x224: every ``test_*`` / ``test_aligned_*``
    key, and the program's launches exactly those of an unguided and a guided
    chain per test batch; then suites filled from the ``.npy`` dumps give the
    same values."""
    import numpy as np
    import torch
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_pipeline
    from prediff_torch.evaluation import FrechetVideoDistance

    cfg = prediff_default_config()
    L = cfg.layout
    argv = ["--save", root, "--test", "--num-samples", "2", "--ddim-steps",
            str(CLI_TEST_DDIM_STEPS)]
    args = tp.parse_args(argv)
    dm = WindowModule(cfg.optim.micro_batch_size, cfg.dataset.seq_len, L.img_height, 0)
    if route == "main":
        tp.main(argv + ["--synthetic"])
        mark()
        with open(os.path.join(root, "metrics.jsonl")) as f:
            results = json.loads(f.readline())
        dm = tp.data_module(cfg, tp.parse_args(argv + ["--synthetic"]), root)
    else:
        ld = build_pipeline(cfg, with_alignment=True, device=device, params=weights)
        results = tp.run_eval(args, cfg, ld, dm, root)
        mark()
    batches = sum(f.endswith("_sample0.npy") for f in os.listdir(os.path.join(root, "npy")))
    want = [f"{p}_{k}" for p in ("test", "test_aligned") for k in EVAL_KEYS]
    missing = [k for k in want + list(CLI_TEST_SMOKE_KEYS) if k not in results]
    # the same suites refilled from the dumps (the program's tensors, as saved)
    feature_fn, nf = tp.build_fvd_feature_fn(cfg, None)
    again = {}
    batch = torch.from_numpy(next(iter(dm.test_batches()))).to(device)
    x = batch[:, L.in_len:L.in_len + L.out_len]
    for suffix, prefix in (("_aligned", "test_aligned"), ("", "test")):
        suite = tp.make_suite(cfg, FrechetVideoDistance(feature_fn=feature_fn, num_features=nf,
                                                        auto_t=True, reset_real_features=False))
        preds = torch.from_numpy(np.stack([np.load(os.path.join(
            root, "npy", f"batch0_rank0_sample{i}{suffix}.npy")) for i in range(2)])).to(device)
        suite.update(preds, x)
        again.update(suite.compute(prefix))
    worst = {}
    for k, v in again.items():
        tol = CLI_FVD_TOL_REL if k.endswith("fvd_epoch") else CLI_TOL_REL
        err = worst[k] = abs(v - results[k]) / max(1.0, abs(v))
        if err > tol or not np.isfinite(results[k]):
            missing.append(f"{k}: {results[k]} vs {v}")
    failed = [f"keys or values: {missing}"] if missing else []
    return ({"route": route, "ddim_steps": CLI_TEST_DDIM_STEPS, "members": 2,
             "batch": cfg.optim.micro_batch_size, "i3d_classes": nf,
             "fvd_resolution": cfg.eval.fvd_resolution, "keys": len(results),
             "worst_rel_err_refilled": max(worst.values()) if worst else None,
             "tol_rel": CLI_TOL_REL, "fvd_tol_rel": CLI_FVD_TOL_REL,
             "test_fvd_epoch": results.get("test_fvd_epoch"),
             "test_aligned_csi_avg_epoch": results.get("test_aligned_csi_avg_epoch"),
             "npy": sorted(os.listdir(os.path.join(root, "npy"))),
             "expected_launches": chain_launches(per, CLI_TEST_DDIM_STEPS * batches,
                                                 CLI_TEST_DDIM_STEPS * batches),
             "failed": failed}, CLI_GUIDED_KERNELS)


def cli_vae(device, route, root, weights, per, mark):
    """``train_vae_sevirlr`` at ``vae_training_default_config()`` (B=8
    frames of 128x128): ``CLI_TRAINER_STEPS`` steps, finite losses,
    ``ckpt_vae``; ms per step beside the ``vae_train`` phase's."""
    import numpy as np
    from prediff_torch.cli import train_vae_sevirlr as tv
    from prediff_torch.config import vae_training_default_config
    from prediff_torch.training import VAETrainer
    from prediff_torch.utils.checkpoint import all_steps

    cfg = vae_training_default_config()
    argv = ["--save", root, "--max-steps", str(CLI_TRAINER_STEPS)]
    with timed_method(VAETrainer, "train_step", device) as steps:
        if route == "main":
            tv.main(argv + ["--synthetic"])
            logs = {}
        else:
            dm = WindowModule(cfg.optim.micro_batch_size, 1, cfg.layout.img_height,
                              CLI_TRAINER_STEPS)
            logs = tv.train(tv.parse_args(argv), cfg, dm, device, root)
    saved = all_steps(os.path.join(root, "ckpt_vae"))
    failed = []
    if saved != [CLI_TRAINER_STEPS] or len(steps.ms) != CLI_TRAINER_STEPS:
        failed.append(f"{len(steps.ms)} steps, ckpt_vae steps {saved}")
    if not all(np.isfinite(v) for v in logs.values()):
        failed.append(f"non-finite logs {logs}")
    return ({"route": route, "batch": cfg.optim.micro_batch_size, "step_ms": steps.ms,
             "ms_per_step": median(steps.ms[1:]),
             "vae_train_phase_ms_this_run": PHASE_NUMBERS.get(
                 ("vae_train", cfg.model.loss.disc_start), {}).get("ms_per_step"),
             "nll_loss": logs.get("train/nll_loss"), "ckpt_vae_steps": saved,
             "failed": failed}, ())


def cli_align(device, route, root, weights, per, mark):
    """``train_sevirlr_avg_x`` at ``alignment_default_config()`` (B=2 pixel
    windows through the frozen VAE, rates 0.1): ``CLI_TRAINER_STEPS``
    micro-steps, finite metrics, ``ckpt_align``; ms per micro-step beside
    the ``align_train`` phase's."""
    import numpy as np
    from prediff_torch.cli import train_sevirlr_avg_x as ta
    from prediff_torch.config import alignment_default_config
    from prediff_torch.training import AlignmentTrainer
    from prediff_torch.utils.checkpoint import all_steps

    cfg = alignment_default_config()
    argv = ["--save", root, "--max-steps", str(CLI_TRAINER_STEPS)]
    with timed_method(AlignmentTrainer, "train_step", device) as steps:
        if route == "main":
            ta.main(argv + ["--synthetic"])
            metrics = {}
        else:
            dm = WindowModule(cfg.optim.micro_batch_size, cfg.dataset.seq_len,
                              cfg.layout.img_height, CLI_TRAINER_STEPS)
            metrics = ta.train(ta.parse_args(argv), cfg, dm, device, root)
    saved = all_steps(os.path.join(root, "ckpt_align"))
    failed = []
    if saved != [CLI_TRAINER_STEPS] or len(steps.ms) != CLI_TRAINER_STEPS:
        failed.append(f"{len(steps.ms)} steps, ckpt_align steps {saved}")
    if not all(np.isfinite(v) for v in metrics.values()):
        failed.append(f"non-finite metrics {metrics}")
    return ({"route": route, "batch": cfg.optim.micro_batch_size, "step_ms": steps.ms,
             "ms_per_micro_step": median(steps.ms[1:]),
             "align_train_phase_ms_this_run": PHASE_NUMBERS.get("align_train"),
             "relative_mae": metrics.get("relative_mae"), "ckpt_align_steps": saved,
             "failed": failed}, CLI_ALIGN_KERNELS)


def cli_convert(device, route, root, weights, per, mark):
    """``convert_pretrained`` on ``.pt`` files of the randomized full-width
    models (the reference's names); ``PreDiffPredictor.from_npz`` on its
    output forecasts bit for bit what ``from_torch`` on the ``.pt`` files
    does (guided, ``CLI_CONVERT_DDIM_STEPS`` DDIM steps, one seed); the
    launches are the ``from_npz`` forecast's alone, exactly one guided
    chain's."""
    import torch
    from prediff_torch.cli import convert_pretrained
    from prediff_torch.config import prediff_default_config
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.checkpoint import PRETRAINED_NAMES

    cfg = prediff_default_config()
    pt, out = os.path.join(root, "pt"), os.path.join(root, "weights")
    os.makedirs(pt)
    for key, name in (("unet", "earthformerunet"), ("vae", "vae"), ("align", "alignment")):
        torch.save(weights[key], os.path.join(pt, PRETRAINED_NAMES[name]))
    t0 = time.perf_counter()
    convert_pretrained.main(["--pt-dir", pt, "--out", out])
    convert_s = time.perf_counter() - t0
    L = cfg.layout
    context = torch.rand((1, L.in_len, L.img_height, L.img_width, 1),
                         generator=torch.Generator().manual_seed(SEED + 11))
    avg = torch.full((1, 1), AVG_X_GT)
    forecasts = {}
    for name, make in (("from_npz", PreDiffPredictor.from_npz),
                       ("from_torch", PreDiffPredictor.from_torch)):
        predictor = make(out if name == "from_npz" else pt, cfg, device=device)
        forecasts[name] = predictor.predict(
            context, use_alignment=True, avg_x_gt=avg, ddim_steps=CLI_CONVERT_DDIM_STEPS,
            generator=torch.Generator(device).manual_seed(SEED)).cpu()
        if name == "from_npz":
            mark()
        del predictor
    equal = torch.equal(forecasts["from_npz"], forecasts["from_torch"])
    failed = [] if equal and torch.isfinite(forecasts["from_npz"]).all() else [
        "the from_npz forecast differs from the from_torch one"]
    return ({"route": route, "npz": sorted(os.listdir(out)), "convert_s": convert_s,
             "npz_mib": sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
             / 2**20, "forecast_bit_equal": equal, "ddim_steps": CLI_CONVERT_DDIM_STEPS,
             "expected_launches": chain_launches(per, guided_steps=CLI_CONVERT_DDIM_STEPS),
             "failed": failed}, CLI_GUIDED_KERNELS)


def cli_learning_check(device, route, root, weights, per, mark):
    """``learning_check`` on the card (400 steps of configs/tiny_smoke.yaml,
    whose widths take the library routes): ``LEARNS OK`` after the
    first-20 and last-20 means."""
    import contextlib
    import io

    from prediff_torch.cli import learning_check

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = learning_check.main([])
    lines = out.getvalue().splitlines()
    print("\n".join(lines[-3:]))
    means = next((ln for ln in lines if ln.startswith("first20=")), "")
    ok = rc == 0 and lines[-1:] == ["LEARNS OK"] and means and lines.index(means) < len(lines) - 1
    return ({"route": route, "rc": rc, "means": means, "last_line": lines[-1] if lines else None,
             "failed": [] if ok else [f"learning_check: {lines[-3:]}"]}, ())


def cli_alone(device, smi):
    """``--only cli``: the randomized full-width models as ``run`` makes them,
    then the ``cli_*`` phases."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(cfg), gen, randomize=True)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    weights = {key: m.state_dict() for key, m in models.items()}
    cli_phases(device, smi, weights, path_launches(models["unet"], models["align"]),
               *kernel_counters())


MESH_MEMBERS = 8          # mesh_ensemble / mesh_guided: one context, 8 members, 4 a rank
MESH_DDPM_STEPS = 20
MESH_DDIM_STEPS = 10      # mesh_guided and mesh_nccl_graph
MESH_NCCL_MEMBERS = 2
MESH_EVAL_DDIM_STEPS = 4
MESH_EVAL_MEMBERS = 2
# rel-L2 of a sharded ensemble against the one-process ensemble of 8 on one card: a
# forward at a batch of 4 rounds otherwise than at 8 (``--only mesh`` names the calls:
# the FFN kernel, whose split of the hidden dimension grows with fewer row tiles, cuBLAS
# and cuDNN), and a last-bit difference flips a kernel's bf16 operand rounding, which the
# chain carries on (the kernels' bar against their plain versions is 2e-2); sharding
# itself is held to the bit by the noise-free chain, equal to one process at the rank's
# batch, and the guided chain's all-reduce by the guidance's own check below (at full
# width the guided chain without it lands as near the one-process ensemble)
MESH_ENSEMBLE_TOL = 1e-2
MESH_GUIDED_TOL = 1e-2
# rel of the guidance's energy and shift on the ranks' rows against one process's at the
# rank's batch, rescaled to the whole batch's energy (the rescale's rounding); each rank's
# energy alone (the control) misses it by far
MESH_SHIFT_TOL = 1e-5
MESH_TIMEOUT_S = 600      # a rank that has not finished by then is killed and the phase fails


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def memory_state(device) -> dict:
    """GiB: the card's free and total memory and this process's reserved
    share of it, the host's free memory, and the largest resident set of
    this process and of its finished children."""
    import resource

    import torch

    out = {"host_free_gib": os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 2**30,
           "self_max_rss_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
           "children_max_rss_gib":
               resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 2**20}
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        out.update(card_free_gib=free / 2**30, card_total_gib=total / 2**30,
                   reserved_gib=torch.cuda.memory_reserved(device) / 2**30)
    return out


def progress(device, stage: str, seconds: float, peaks: dict) -> None:
    """A rank's stage as it is reached: ``peaks[stage]`` the most card
    memory allocated and reserved (GiB) since the stage before (the
    counters then start again), and the stage to the rank's log, for the
    report of a rank that fails."""
    import torch

    if device.type == "cuda":
        peaks[stage] = [torch.cuda.max_memory_allocated(device) / 2**30,
                        torch.cuda.max_memory_reserved(device) / 2**30]
        torch.cuda.reset_peak_memory_stats(device)
    print(json.dumps({"stage": stage, "s": seconds, "peak_gib": peaks.get(stage)}), flush=True)


RANK_MEMORY_ENV = "CHIP_SMOKE_RANK_GIB"   # each rank's share of the card, set by run_ranks
RANK_MEMORY_MARGIN_GIB = 3.0   # the card memory the processes' CUDA contexts take beside


def rank_memory_share(device) -> None:
    """Hold this rank's allocator to its share of the card (``run_ranks``
    sets it): at its share it gives back its own cached blocks before it
    asks for more, so one rank's cache can never starve the other's."""
    import torch

    share = os.environ.get(RANK_MEMORY_ENV)
    if share and device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
        torch.cuda.set_per_process_memory_fraction(float(share) * 2**30 / total, device)


def run_ranks(kind: str, root: str, log_prefix: str, timeout_s: float, device) -> dict:
    """Start two ranks of this script (``--{kind}-child ROOT RANK``), each
    writing its output to ``ROOT/{log_prefix}{RANK}.log``, once this process
    has given back the card memory it holds no tensor in, each held to half
    of what is then free (``rank_memory_share``); wait at most
    ``timeout_s`` seconds for both, kill any still running, and fail, with
    every rank's exit and log tail (the rank that failed first last), if one
    did not exit 0.  Returns the children's seconds and the memory (GiB) as
    they started and as they ended."""
    import gc

    import torch

    gc.collect()   # cycles may hold card tensors or graphs the cache cannot give back
    if device.type == "cuda":
        torch.cuda.empty_cache()
    at_start = memory_state(device)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    if device.type == "cuda":   # the card's free memory split between the two ranks
        at_start["rank_share_gib"] = (at_start["card_free_gib"] - RANK_MEMORY_MARGIN_GIB) / 2
        env[RANK_MEMORY_ENV] = repr(at_start["rank_share_gib"])
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for r in range(2):
            logs.append(open(os.path.join(root, f"{log_prefix}{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), f"--{kind}-child", root, str(r)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
        deadline = time.time() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.perf_counter() - t0
    at_end = memory_state(device)
    if any(p.returncode != 0 for p in procs):
        ranks = []
        for r, p in enumerate(procs):
            with open(os.path.join(root, f"{log_prefix}{r}.log")) as f:
                tail = f.read()[-3000:]
            code = p.returncode
            ranks.append((r, f"killed by signal {-code}" if code < 0 else f"exit {code}", tail,
                          # a rank whose peer went away reports the peer, not the cause
                          code == 0 or "closed by peer" in tail or "Connection reset" in tail))
        report = "".join(f"\n---- {kind} rank {r} ({exit_}), the end of its log:\n{tail}"
                         for r, exit_, tail, _ in sorted(ranks, key=lambda x: not x[3]))
        exits = ", ".join(f"rank {r} {exit_}" for r, exit_, _, _ in ranks)
        fail(f"{kind} ranks: {report}\n---- {kind} ranks exited: {exits} after {seconds:.1f} s; "
             f"memory (GiB) as they started {at_start}, as they ended {at_end}")
    return {"children_seconds": seconds, "memory_at_start_gib": at_start,
            "memory_at_end_gib": at_end}


class chain_probe:
    """For the ``with`` block: each chain's x_T and step noise as the rank
    holds them (its rows of the whole batch's draws), its step loop's
    seconds (synchronized) less the seconds its graphs took to capture, as
    ``timed_chain`` counts them, and those capture seconds, by wrappers
    around ``ld._chain`` and ``ld._draw``."""

    def __init__(self, ld, device, keep_draws: bool = False):
        self.ld, self.device, self.keep = ld, device, keep_draws
        self.x_T, self.noise, self.loops, self.capture_s = None, [], [], []

    def __enter__(self):
        ld, chain, draw = self.ld, self.ld._chain, self.ld._draw
        current = {}

        def probed_chain(plan, bufs, generator, entry):
            current["bufs"] = bufs
            if self.keep:
                self.x_T = bufs.z.clone()
            capture_s = ld.graphs.capture_seconds
            sync(self.device)
            t0 = time.perf_counter()
            ends = chain(plan, bufs, generator, entry)
            sync(self.device)
            self.capture_s.append(ld.graphs.capture_seconds - capture_s)
            self.loops.append(time.perf_counter() - t0 - self.capture_s[-1])
            return ends

        def probed_draw(buf, generator):
            draw(buf, generator)
            bufs = current.get("bufs")
            if self.keep and bufs is not None and buf is bufs.noise_all:
                self.noise.append(bufs.noise.clone())

        ld._chain, ld._draw = probed_chain, probed_draw
        return self

    def __exit__(self, *exc):
        del self.ld._chain, self.ld._draw


def batch_split_probe(ld, z, y, t: int) -> dict:
    """``--only mesh``: where a forward at a batch of 8 rounds otherwise than
    at 4 + 4.  The UNet forward (at step ``t``), the encode and the decode
    run on the whole batch and on its halves; in the whole batch's run every
    call of a hand-written kernel (rows 1-3: the batch-led inputs cut, both
    halves through the kernel and through its plain version on the card)
    and every library layer (Linear, the convolutions on cuDNN, GroupNorm,
    LayerNorm) runs again on the two halves of its input.  Per name: the
    calls, how many differ between the whole and the halves, and the largest
    difference (0: no batch dependence)."""
    import inspect

    import torch
    from torch import nn
    from prediff_torch.models import cuboid_attention, layers
    from prediff_torch.ops.attention import axial_attention_plain
    from prediff_torch.ops.ffn import ffn_plain
    from prediff_torch.ops.groupnorm import groupnorm_silu_plain

    stats, active = {}, [False]

    def note(name, whole, parts):
        d = float((whole - torch.cat(parts)).abs().max())
        s = stats.setdefault(name, {"calls": 0, "differ": 0, "max_abs": 0.0})
        s["calls"] += 1
        s["differ"] += int(d > 0)
        s["max_abs"] = max(s["max_abs"], d)

    def spied(name, kernel, plain, batch_led):
        keep = inspect.signature(plain).parameters

        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            n = args[0].shape[0]
            if active[0] and n % 2 == 0:
                active[0] = False
                halves = [[a[h] if i in batch_led and isinstance(a, torch.Tensor) else a
                           for i, a in enumerate(args)]
                          for h in (slice(0, n // 2), slice(n // 2, n))]
                note(name, out, [kernel(*a, **kwargs) for a in halves])
                pkw = {k: v for k, v in kwargs.items() if k in keep}
                note(name + "_plain", plain(*args, **pkw), [plain(*a, **pkw) for a in halves])
                active[0] = True
            return out
        return run

    def hook(module, inputs, out):
        x = inputs[0] if len(inputs) == 1 else None
        if active[0] and isinstance(x, torch.Tensor) and x.dim() and x.shape[0] % 2 == 0:
            n = x.shape[0]
            note(type(module).__name__, out,
                 [module.forward(x[:n // 2]), module.forward(x[n // 2:])])

    patched = [(layers, "fused_ffn", spied("ffn", layers.fused_ffn, ffn_plain, (0,))),
               (layers, "fused_groupnorm_silu", spied(
                   "groupnorm_silu", layers.fused_groupnorm_silu, groupnorm_silu_plain, (0, 3))),
               (cuboid_attention, "fused_axial_attention", spied(
                   "axial_attention", cuboid_attention.fused_axial_attention,
                   axial_attention_plain, (0,)))]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patched]
    library = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d,
               nn.ConvTranspose3d, nn.GroupNorm, nn.LayerNorm)
    handles = [m.register_forward_hook(hook) for model in (ld.unet, ld.vae)
               for m in model.modules() if isinstance(m, library)]
    for mod, attr, fn in patched:
        setattr(mod, attr, fn)
    out = {}
    try:
        with torch.no_grad():
            n = z.shape[0]
            tb = torch.full((n,), t, device=z.device)
            zc = ld.cond_stage_forward(y)
            for name, fn in (("unet", lambda h: ld.unet(z[h], tb[h], zc[h])),
                             ("encode", lambda h: ld.cond_stage_forward(y[h])),
                             ("decode", lambda h: ld.decode_first_stage(z[h]))):
                stats.clear()
                active[0] = True
                whole = fn(slice(None))
                active[0] = False
                parts = [fn(slice(0, n // 2)), fn(slice(n // 2, n))]
                out[name] = {"8_vs_4_max_abs": float((whole - torch.cat(parts)).abs().max()),
                             "calls": dict(sorted(stats.items()))}
    finally:
        for h in handles:
            h.remove()
        for mod, attr, fn0 in saved:
            setattr(mod, attr, fn0)
    return out


def mesh_phases(device, smi, cfg, weights, per, diagnose: bool = False) -> dict:
    """The sharded forecasts and the rank-sharded evaluation
    (``prediff_torch/parallel``) on ranks that are child processes of this
    script (``--mesh-child``), each joining its group by
    ``init_distributed`` itself; this process's group and state stay as they
    were.  One card holds them all, so the two-rank phases run gloo (whose
    collectives go through the host) and the NCCL phase one rank.  First the
    one-process references on this card, on graphs: the ``MESH_MEMBERS``
    ensemble of one context, ``MESH_DDPM_STEPS`` DDPM steps (its x_T and step
    noise kept), and the guided ``MESH_DDIM_STEPS``-step DDIM ensemble.
    Then two ranks, ``PreDiffPredictor(mesh="auto")``:
    ``mesh_ensemble`` (each rank's x_T and noise are its rows of the
    one-process draw bit for bit, both ranks return the same tensor, within
    ``MESH_ENSEMBLE_TOL`` rel-L2 of the one-process ensemble, exact launches
    per rank: the chain's per-step counts, no plain call), ``mesh_guided``
    (route "eager": gloo cannot capture the all-reduce; within
    ``MESH_GUIDED_TOL``; the guidance's energy and shift on fixed inputs,
    each rank its rows, within ``MESH_SHIFT_TOL`` of one process's, which
    each rank's energy alone misses), ``mesh_eval`` (``train_sevirlr_prediff --test
    --multihost``: the reduced metrics equal the merge of the ranks' suites
    before the reduce bit for bit, dumps named by rank, one metrics record,
    rank 0's), then rank 0 alone in a new NCCL group of one:
    ``mesh_nccl_graph`` (guided DDIM with the mesh on graphs, the all-reduce
    inside the captured step, bit-equal to its eager chain and to the call
    without a mesh).  A step's ms leaves out its graphs' capture, given as
    ``capture_s``.  Per-step times of two ranks on one card share it: they
    are no scaling.  ``diagnose`` (``--only mesh``) adds ``mesh_batch_split``
    (``batch_split_probe``: which calls round a batch of 8 otherwise than
    4 + 4) and the guided chain without the all-reduce.  Returns rank 0's
    launches by phase."""
    import torch
    from prediff_torch.config import save_yaml
    from prediff_torch.serving import PreDiffPredictor

    t_all = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        save_yaml(cfg, os.path.join(root, "cfg.yaml"))
        torch.save(weights, os.path.join(root, "weights.pt"))
        img = cfg.layout
        context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                             generator=torch.Generator().manual_seed(SEED + 31))
        avg = torch.full((1, 1), AVG_X_GT)
        predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True, device=device,
                                     mesh=None)
        with chain_probe(predictor.ld, device, keep_draws=True) as ens_probe:
            ens = predictor.predict_ensemble(
                context, MESH_MEMBERS, timesteps=MESH_DDPM_STEPS,
                generator=torch.Generator(device).manual_seed(SEED))
        with chain_probe(predictor.ld, device) as guided_probe:
            guided = predictor.predict_ensemble(
                context, MESH_MEMBERS, ddim_steps=MESH_DDIM_STEPS, use_alignment=True,
                avg_x_gt=avg, generator=torch.Generator(device).manual_seed(SEED + 1))
        # the noise-free chain (x_T given, temperature 0) on each rank's rows alone, a
        # batch of 4 as on a rank
        y8 = torch.repeat_interleave(context, MESH_MEMBERS, dim=0).to(device)
        x_T = torch.randn((MESH_MEMBERS,) + tuple(cfg.model.diffusion.latent_shape),
                          generator=torch.Generator().manual_seed(SEED + 3))
        halves = [slice(0, MESH_MEMBERS // 2), slice(MESH_MEMBERS // 2, MESH_MEMBERS)]

        def noise_free(rows):
            return predictor.ld.sample(y8[rows], x_T=x_T[rows], timesteps=MESH_DDPM_STEPS,
                                       temperature=0.0).cpu()

        by_half = torch.cat([noise_free(h) for h in halves])
        if diagnose:   # why the whole batch of 8 is not the one of 4 + 4
            whole = noise_free(slice(None))
            emit({"phase": "mesh_batch_split",
                  "noise_free_whole_vs_halves_rel_l2": rel_l2_and_cosine([whole], [by_half])[0],
                  "noise_free_whole_vs_halves_bit_equal": bool(torch.equal(whole, by_half)),
                  **batch_split_probe(predictor.ld, x_T.to(device), y8, MESH_DDPM_STEPS - 1),
                  "card": smi})
        # the guidance's energy and shift on fixed inputs: each rank's rows alone, a batch of
        # 4 as on a rank, rescaled to the energy of both (the ranks' shift is each rank's own
        # times its energy over the whole's), and the whole batch of 8's
        align, z8 = predictor.ld.alignment, x_T.to(device)
        t8 = torch.full((MESH_MEMBERS,), MESH_DDPM_STEPS - 1, device=device)
        avg8 = avg.expand(MESH_MEMBERS, 1).to(device)
        alone = [(align.alignment_energy(z8[h], t8[h], avg8[h]),
                  align.get_mean_shift(z8[h], t8[h], avg8[h])) for h in halves]
        energy = torch.sqrt(sum(e.square() for e, _ in alone))
        shift = torch.cat([s * (e / energy) for e, s in alone]).cpu()
        energy = energy.reshape(1).cpu()
        energy_whole = align.alignment_energy(z8, t8, avg8).reshape(1).cpu()
        shift_whole = align.get_mean_shift(z8, t8, avg8).cpu()
        torch.save({"context": context, "avg": avg, "ensemble": ens.cpu(),
                    "x_T": ens_probe.x_T.cpu(), "noise": torch.stack(ens_probe.noise).cpu(),
                    "guided": guided.cpu(), "noise_free_x_T": x_T, "noise_free_by_half": by_half,
                    "energy": energy, "shift": shift, "energy_whole": energy_whole,
                    "shift_whole": shift_whole},
                   os.path.join(root, "reference.pt"))
        one_ms = {"mesh_ensemble": 1e3 * ens_probe.loops[-1] / MESH_DDPM_STEPS,
                  "mesh_guided": 1e3 * guided_probe.loops[-1] / MESH_DDIM_STEPS}
        one_capture_s = {"mesh_ensemble": ens_probe.capture_s[-1],
                         "mesh_guided": guided_probe.capture_s[-1]}
        del predictor, ens_probe, guided_probe
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(os.path.join(root, "plan.json"), "w") as f:
            json.dump({"device": str(device), "world": 2, "port": free_port(),
                       "port2": free_port(),
                       "nccl_backend": "nccl" if device.type == "cuda" else "gloo",
                       "per": per, "members": MESH_MEMBERS, "ddpm_steps": MESH_DDPM_STEPS,
                       "ddim_steps": MESH_DDIM_STEPS, "nccl_members": MESH_NCCL_MEMBERS,
                       "eval_ddim_steps": MESH_EVAL_DDIM_STEPS,
                       "eval_members": MESH_EVAL_MEMBERS, "diagnose": diagnose}, f)
        t0 = time.perf_counter()
        children = run_ranks("mesh", root, "rank", MESH_TIMEOUT_S, device)
        res = []
        for r in range(2):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                res.append(json.load(f))

        def outputs(name):
            return [torch.load(os.path.join(root, f"rank{r}_{name}.pt")) for r in range(2)]

        ref = torch.load(os.path.join(root, "reference.pt"))

        def noise_free():
            """Sharding itself: the noise-free sharded chain bit for bit one
            process's at the rank's batch (and both ranks alike)."""
            free = outputs("mesh_noise_free")
            return {"noise_free_sharded_bit_equal": bool(
                        torch.equal(free[0], ref["noise_free_by_half"])
                        and torch.equal(free[0], free[1]))}

        def guidance(want):
            """The guidance on fixed inputs, each rank its rows: the energy
            summed over the ranks, and the shift, within ``MESH_SHIFT_TOL`` of
            one process's at the rank's batch rescaled to the whole's energy;
            each rank's energy alone, the control, must miss it.  Beside them
            (no bar) the same against the whole batch of 8 in one process.
            With ``diagnose`` also the guided chain with the all-reduce left
            out."""
            line = {"tol_shift": MESH_SHIFT_TOL}
            for kind, prefix in (("summed", ""), ("alone", "no_reduce_")):
                e, sh = outputs(f"energy_{kind}"), torch.cat(outputs(f"shift_{kind}"))
                for whole in ("", "_whole"):
                    line[f"{prefix}energy_rel_vs_one_process{whole}"] = max(
                        float((x - ref["energy" + whole]).abs().max()
                              / ref["energy" + whole].abs().max()) for x in e)
                    line[f"{prefix}shift_rel_l2_vs_one_process{whole}"] = rel_l2_and_cosine(
                        [sh], [ref["shift" + whole]])[0]
            if diagnose:
                line["no_reduce_chain_rel_l2_vs_one_process"] = rel_l2_and_cosine(
                    [outputs("mesh_guided_no_reduce")[0]], [want])[0]
            return line

        for name, want, tol in (("mesh_ensemble", ref["ensemble"], MESH_ENSEMBLE_TOL),
                                ("mesh_guided", ref["guided"], MESH_GUIDED_TOL)):
            got = outputs(name)
            rel, _ = rel_l2_and_cosine([got[0]], [want])
            line = {"phase": name, **res[0][name],
                    "rank1": {k: res[1][name][k] for k in ("launches", "ms_per_step",
                                                           "capture_s", "draws_bit_equal")
                              if k in res[1][name]},
                    "ranks_bit_equal": bool(torch.equal(got[0], got[1])),
                    "rel_l2_vs_one_process": rel, "tol_rel_l2": tol,
                    "max_abs_vs_one_process": float((got[0] - want).abs().max()),
                    "bit_equal_to_one_process": bool(torch.equal(got[0], want)),
                    "one_process_ms_per_step": one_ms[name],
                    "one_process_capture_s": one_capture_s[name],
                    **(noise_free() if name == "mesh_ensemble" else guidance(want)),
                    "ms_per_step_is": "two ranks sharing one card: not scaling", "card": smi}
            emit(line)
            failed = list(res[0][name]["failed"]) + list(res[1][name]["failed"])
            if not line["ranks_bit_equal"]:
                failed.append("the ranks' outputs differ")
            if not (rel <= tol) or not bool(torch.isfinite(got[0]).all()):
                failed.append(f"rel-L2 {rel} against the one-process ensemble > {tol}")
            if name == "mesh_ensemble" and not line["noise_free_sharded_bit_equal"]:
                failed.append("the noise-free sharded chain differs from one process at the "
                              "rank's batch")
            if name == "mesh_guided":
                for key in ("energy_rel_vs_one_process", "shift_rel_l2_vs_one_process"):
                    if not line[key] <= MESH_SHIFT_TOL:
                        failed.append(f"the ranks' guidance {key} {line[key]} > {MESH_SHIFT_TOL}")
                    if not line["no_reduce_" + key] > MESH_SHIFT_TOL:
                        failed.append(f"without the all-reduce the guidance's {key} is within "
                                      f"{MESH_SHIFT_TOL} too: the bar tells nothing")
            if failed:
                fail(f"{name}: {failed}")
            launches[name] = res[0][name]["launches"]
        for name in ("mesh_nccl_graph", "mesh_eval"):
            line = {"phase": name, **res[0][name], "card": smi}
            if name == "mesh_eval":
                line["rank1"] = {k: res[1][name][k] for k in ("launches", "plain_calls_on_card")}
            emit(line)
            failed = list(res[0][name]["failed"]) + list(res[1].get(name, {}).get("failed", []))
            if failed:
                fail(f"{name}: {failed}")
            launches[name] = res[0][name]["launches"]
    emit({"phase": "mesh_all", "seconds": time.perf_counter() - t_all, **children,
          "reference_seconds": t0 - t_all, "rank_stages_s": [r["stages_s"] for r in res],
          "rank_peak_gib_by_stage": [r["peak_gib_by_stage"] for r in res], "card": smi})
    return launches


def counted_phase(device, counters, spy, fn, want) -> dict:
    """``fn()``'s line with the kernels' counts set to 0 just before and read
    just after (``counters``: ``kernel_counters()``), a spy on the plain
    versions (``spy``: ``plain_spy()``); ``want(line)`` the exact launches
    (None: not checked).  Failures go to the line's ``failed``."""
    zero_counts, read_counts = counters
    install, spied, remove = spy
    install()
    try:
        zero_counts()
        sync(device)
        t0 = time.perf_counter()
        line = fn()
        sync(device)
        seconds = time.perf_counter() - t0
        counts = read_counts()
    finally:
        remove()
    plain, _ = spied()
    line = {**line, "seconds": seconds, "launches": {k: v for k, v in counts.items() if v},
            "plain_calls_on_card": plain}
    failed = line.setdefault("failed", [])
    if plain:
        failed.append(f"plain versions ran on the card: {plain}")
    want = want(line)
    if want is not None:
        wrong = {k: [n, want.get(k, 0)] for k, n in counts.items() if n != want.get(k, 0)}
        line["expected_launches"] = want
        if wrong:
            failed.append(f"launches [counted, expected] {wrong}")
    return line


def mesh_child(root: str, rank: int) -> int:
    """One rank of ``mesh_phases`` (``--mesh-child ROOT RANK``): its results
    in ``ROOT/rank{RANK}.json`` and its outputs beside it; a failed check is
    listed there, an error exits non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import load_config, prediff_default_config
    from prediff_torch.diffusion import knowledge_alignment
    from prediff_torch.evaluation import ForecastEvalSuite, FrechetVideoDistance
    from prediff_torch.parallel import init_distributed, local_batch_slice, make_mesh
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.device import set_numerics

    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    device = torch.device(plan["device"])
    rank_memory_share(device)
    per = plan["per"]
    members, ddpm_steps, ddim_steps = plan["members"], plan["ddpm_steps"], plan["ddim_steps"]
    eval_members, eval_ddim_steps = plan["eval_members"], plan["eval_ddim_steps"]
    nccl_members = plan["nccl_members"]
    cfg = load_config(prediff_default_config, os.path.join(root, "cfg.yaml"))
    weights = torch.load(os.path.join(root, "weights.pt"))
    ref = torch.load(os.path.join(root, "reference.pt"))
    context, avg = ref["context"], ref["avg"]
    set_numerics()
    zero_counts, read_counts = kernel_counters()
    install, spied, remove = plain_spy()
    stages = {"loaded": time.perf_counter() - T0}   # seconds since the process started
    peaks = {}   # stage -> GiB allocated and reserved at most since the stage before
    out = {"stages_s": stages, "peak_gib_by_stage": peaks}

    def phase(name, fn, want):
        out[name] = counted_phase(device, (zero_counts, read_counts),
                                  (install, spied, remove), fn, want)
        stages[name] = time.perf_counter() - T0
        progress(device, name, stages[name], peaks)

    def save(name, t):
        torch.save(t.cpu(), os.path.join(root, f"rank{rank}_{name}.pt"))

    init_distributed(coordinator_address=f"localhost:{plan['port']}",
                     num_processes=plan["world"], process_id=rank, backend="gloo",
                     device=device, timeout=120.0)
    predictor = PreDiffPredictor(cfg, params=weights, with_alignment=True)   # mesh="auto"
    ld, mesh = predictor.ld, predictor.mesh
    stages["joined_and_built"] = time.perf_counter() - T0
    rows = local_batch_slice(members, mesh.size, mesh.index)

    def ensemble():
        with chain_probe(ld, device, keep_draws=True) as probe:
            ens = predictor.predict_ensemble(context, members, timesteps=ddpm_steps,
                                             generator=torch.Generator(device).manual_seed(SEED))
        save("mesh_ensemble", ens)
        draws = (torch.equal(probe.x_T.cpu(), ref["x_T"][rows])
                 and torch.equal(torch.stack(probe.noise).cpu(), ref["noise"][:, rows]))
        return {"ranks": mesh.size, "backend": mesh.backend, "members": members,
                "members_per_rank": rows.stop - rows.start, "steps": ddpm_steps,
                "draws_bit_equal": draws, "noise_draws": len(probe.noise),
                "ms_per_step": 1e3 * probe.loops[-1] / ddpm_steps,
                "capture_s": probe.capture_s[-1], "captured_graphs": ld.graphs.captures,
                "failed": [] if draws else ["x_T or step noise not the one-process rows"]}

    phase("mesh_ensemble", ensemble,
          lambda line: chain_launches(per, unguided_steps=ddpm_steps))
    # the noise-free chain on the whole batch's x_T, outside the counts
    y8 = torch.repeat_interleave(context, members, dim=0)
    save("mesh_noise_free", ld.sample(y8, x_T=ref["noise_free_x_T"], timesteps=ddpm_steps,
                                      temperature=0.0, mesh=mesh))

    def guided():
        captures = ld.graphs.captures
        with chain_probe(ld, device) as probe:
            ens = predictor.predict_ensemble(
                context, members, ddim_steps=ddim_steps, use_alignment=True,
                avg_x_gt=avg, generator=torch.Generator(device).manual_seed(SEED + 1))
        save("mesh_guided", ens)
        routes = [k[-1][-1] for k in ld.graphs._entries if k[-1] is not None]
        new = ld.graphs.captures - captures
        eager = device.type != "cuda" or (routes and routes[-1] == "eager" and new == 0)
        return {"ranks": mesh.size, "backend": mesh.backend, "steps": ddim_steps,
                "avg_x_gt_shape": [members, 1], "route": routes[-1] if routes else None,
                "captures": new, "ms_per_step": 1e3 * probe.loops[-1] / ddim_steps,
                "capture_s": probe.capture_s[-1],
                "failed": [] if eager
                else [f"guided steps on gloo not eager (routes {routes}, captures {new})"]}

    phase("mesh_guided", guided, lambda line: chain_launches(per, guided_steps=ddim_steps))
    # outside the counts: the guidance on this rank's rows of fixed inputs, the energy summed
    # over the ranks and, the control, this rank's alone
    z_r = ref["noise_free_x_T"][rows].to(device)
    t_r = torch.full((z_r.shape[0],), ddpm_steps - 1, device=device)
    avg_r = avg.expand(members, 1)[rows].to(device)
    for kind, m in (("summed", mesh), ("alone", None)):
        save(f"energy_{kind}", ld.alignment.alignment_energy(z_r, t_r, avg_r, mesh=m).reshape(1))
        save(f"shift_{kind}", ld.alignment.get_mean_shift(z_r, t_r, avg_r, mesh=m))
    if plan["diagnose"]:   # the chain's control: the guided chain, each rank's energy alone
        reduce = knowledge_alignment.all_reduce_sum
        knowledge_alignment.all_reduce_sum = lambda t, mesh: t.clone()
        try:
            save("mesh_guided_no_reduce", predictor.predict_ensemble(
                context, members, ddim_steps=ddim_steps, use_alignment=True, avg_x_gt=avg,
                generator=torch.Generator(device).manual_seed(SEED + 1)))
        finally:
            knowledge_alignment.all_reduce_sum = reduce

    def evaluation():
        save_dir = os.path.join(root, "eval")
        argv = ["--save", save_dir, "--cfg", os.path.join(root, "cfg.yaml"), "--test",
                "--multihost", "--num-samples", str(eval_members),
                "--ddim-steps", str(eval_ddim_steps)]
        route = cli_route()["route"]
        if route == "main":
            argv.append("--synthetic")
        else:   # no h5py / pandas: this rank's windows in memory, in place of its shard
            tp.data_module = lambda cfg, args, save_dir: WindowModule(
                cfg.optim.micro_batch_size, cfg.dataset.seq_len, cfg.layout.img_height, 0,
                seed=SEED + 100 * (rank + 1))
        before, prefixes = [], []
        reduce, compute = ForecastEvalSuite.cross_process_reduce, ForecastEvalSuite.compute

        def kept_reduce(suite):
            before.append(suite.state_tree())
            return reduce(suite)

        def kept_compute(suite, prefix):
            prefixes.append(prefix)
            return compute(suite, prefix)

        ForecastEvalSuite.cross_process_reduce = kept_reduce
        ForecastEvalSuite.compute = kept_compute
        try:
            rc = tp.main(argv)
        finally:
            ForecastEvalSuite.cross_process_reduce, ForecastEvalSuite.compute = reduce, compute
        for i, tree in enumerate(before):
            np.savez(os.path.join(root, f"eval_before{rank}_{i}.npz"), **tree)
        dist.barrier()
        mine = [n for n in os.listdir(os.path.join(save_dir, "npy"))
                if n.endswith(f"_rank{rank}_sample0.npy")]
        line = {"route": route, "ranks": mesh.size, "members": eval_members,
                "ddim_steps": eval_ddim_steps, "rc": rc, "batches": len(mine), "failed": []}
        if rank == 0:
            with open(os.path.join(save_dir, "metrics.jsonl")) as f:
                records = [json.loads(x) for x in f]
            merged = {}
            for i, prefix in enumerate(prefixes):
                suites = []
                for r in range(mesh.size):
                    suite = tp.make_suite(cfg, FrechetVideoDistance(
                        feature_fn=lambda v: v, auto_t=True, reset_real_features=False))
                    suite.load_state_tree(dict(np.load(
                        os.path.join(root, f"eval_before{r}_{i}.npz"))))
                    suites.append(suite)
                for other in suites[1:]:
                    suites[0].merge(other)
                merged.update(suites[0].compute(prefix))
            got = {k: v for k, v in records[0].items() if k not in ("step", "time")}
            npy = sorted(os.listdir(os.path.join(save_dir, "npy")))
            differ = sorted(k for k in merged if got.get(k) != merged[k])
            line.update(metrics_records=len(records), keys=len(got),
                        bit_equal_to_merge=not differ and set(got) == set(merged),
                        test_csi_avg_epoch=got.get("test_csi_avg_epoch"),
                        test_fvd_epoch=got.get("test_fvd_epoch"), npy=npy)
            if rc != 0 or len(records) != 1 or differ or set(got) != set(merged):
                line["failed"].append(f"metrics not the merge: records {len(records)}, "
                                      f"differ {differ}")
            if not all(any(f"_rank{r}_" in n for n in npy) for r in range(mesh.size)):
                line["failed"].append(f"dumps not named by both ranks: {npy}")
        return line

    phase("mesh_eval", evaluation, lambda line: chain_launches(
        per, *(2 * [eval_ddim_steps * line["batches"]])))
    dist.barrier()
    dist.destroy_process_group()

    if rank == 0:   # a new group of one rank on NCCL: the captured all-reduce
        init_distributed(coordinator_address=f"localhost:{plan['port2']}", num_processes=1,
                         process_id=0, backend=plan["nccl_backend"], device=device,
                         timeout=120.0)
        predictor.mesh = make_mesh()
        calls = {"all": 0, "captured": 0}
        all_reduce = dist.all_reduce

        def counted(*args, **kwargs):
            calls["all"] += 1
            calls["captured"] += int(device.type == "cuda"
                                     and torch.cuda.is_current_stream_capturing())
            return all_reduce(*args, **kwargs)

        kw = dict(num_samples=nccl_members, ddim_steps=ddim_steps, use_alignment=True,
                  avg_x_gt=avg)

        def forecast():
            return predictor.predict_ensemble(
                context, generator=torch.Generator(device).manual_seed(SEED + 2), **kw)

        def nccl():
            dist.all_reduce = counted
            try:
                captures = ld.graphs.captures
                with chain_probe(ld, device) as probe:
                    graphs = forecast()
                new = ld.graphs.captures - captures
            finally:
                dist.all_reduce = all_reduce
            with ld._plain_chain():
                eager = forecast()
            predictor.mesh = None
            unsharded = forecast()
            ok = torch.equal(graphs, eager) and torch.equal(graphs, unsharded)
            captured_ok = device.type != "cuda" or (calls["captured"] >= 1 and new >= 1)
            return {"ranks": 1, "backend": plan["nccl_backend"], "steps": ddim_steps,
                    "members": nccl_members, "captures": new,
                    "all_reduce_calls": calls["all"],
                    "all_reduce_captured": calls["captured"],
                    "bit_equal_eager_and_unsharded": ok,
                    "ms_per_step": 1e3 * probe.loops[-1] / ddim_steps,
                    "capture_s": probe.capture_s[-1],
                    "note": "the only captured NCCL collective one card can check: a group of "
                            "one rank, whose all-reduce is the identity",
                    "failed": ([] if ok else ["graphs, eager and unsharded differ"])
                    + ([] if captured_ok else ["no all-reduce inside a captured step"])}

        phase("mesh_nccl_graph", nccl,
              lambda line: chain_launches(per, guided_steps=3 * ddim_steps))
        dist.destroy_process_group()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


DDP_TRAIN_MICRO = 4       # ddp_train: 2 optimizer steps at accum 2, one sample a rank
DDP_ACCUM = 2
DDP_ALIGN_STEPS = 2       # ddp_align: one sample a rank
DDP_VAE_FRAMES = 8        # ddp_vae: the global batch of frames, 4 a rank, at disc_start 0
DDP_VAE_STEPS = 2
# rel-L2 of the two ranks' reduced VAE-GAN gradients against one process on the whole
# batch of 8 frames: a batch of 4 rounds otherwise than 8 in cuDNN, so the bar is the
# vae_train_grads phase's card-vs-CPU one (measured on an H100: the generator's 1.7e-4,
# the discriminator's 6.4e-4); each rank's own BatchNorm statistics (the control) must
# miss it (measured 1.7e-2 / 0.12)
DDP_VAE_TOL_REL_L2 = 1e-3
DDP_TIMEOUT_S = 600       # a rank that has not finished by then is killed and the phase fails


def bit_digest(tensors):
    """Per tensor the int64 sums of its float32 bit patterns and of their
    squares (wrapping): equal digests on two ranks mean equal bits but for a
    cancellation no rounding difference makes in practice."""
    import torch

    rows = []
    for t in tensors:
        b = t.detach().contiguous().view(torch.int32).to(torch.int64)
        rows.append(torch.stack([b.sum(), (b * b).sum()]))
    return torch.stack(rows)


def ddp_phases(device, smi, cfg, weights, per) -> dict:
    """DDP training (``training.DiffusionTrainer`` / ``AlignmentTrainer`` /
    ``VAETrainer`` with ``mesh=``) on ranks that are child processes of this
    script (``--ddp-child``): two gloo ranks on the one card (their
    collectives through the host), then rank 0 alone in an NCCL group of one.
    First this process computes the VAE-GAN reference: one process's
    gradients at ``DDP_VAE_FRAMES`` frames.  In the ranks:

    - ``ddp_train``: the recipe's UNet (``weights``) at its rates (0.1), one
      sample a rank, ``DDP_ACCUM`` micro-steps an optimizer step,
      ``DDP_TRAIN_MICRO`` micro-steps.  Before them each rank's local
      gradients against one process's at the rank's batch with the same
      draws and element base, drawn here apart from the trainer (bit-equal),
      and the all-reduced mean against the mean of the two ranks' (bit-equal);
      then the micro-steps with exact launches, the ranks' states bit-equal
      after each, ms per micro-step and per gradient all-reduce.
    - ``ddp_align``: the same for the alignment net (``alignment_default_config``,
      its seeded initialisation), ``DDP_ALIGN_STEPS`` steps.
    - ``ddp_vae``: the VAE-GAN (``vae_training_default_config`` at
      ``disc_start`` 0, seeded) on 4 frames a rank: its reduced gradients
      within ``DDP_VAE_TOL_REL_L2`` of the one-process reference, each rank's
      own BatchNorm statistics (the control) missing it, then
      ``DDP_VAE_STEPS`` steps with the ranks bit-equal after each.
    - ``ddp_nccl``: rank 0 in an NCCL group of one: a micro-step with the mesh
      bit-equal to one without.

    Two ranks on one card show no scaling.  Returns rank 0's launches by
    phase."""
    import torch
    from prediff_torch.config import (alignment_default_config, save_yaml,
                                      vae_training_default_config)
    from prediff_torch.factory import build_vae_trainer

    t_all = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        vcfg = vae_training_default_config()
        vcfg.model.loss.disc_start = 0
        for name, c in (("cfg", cfg), ("align", alignment_default_config()), ("vae", vcfg)):
            save_yaml(c, os.path.join(root, f"{name}.yaml"))
        torch.save({"unet": weights["unet"], "vae": weights["vae"]},
                   os.path.join(root, "weights.pt"))
        # the VAE-GAN reference: one process on the whole batch of frames
        frames = torch.rand((DDP_VAE_FRAMES, vcfg.layout.img_height, vcfg.layout.img_width,
                             vcfg.model.vae.in_channels), generator=torch.Generator().manual_seed(SEED + 41))
        trainer = build_vae_trainer(vcfg, device=device, seed=SEED)
        gen_state, disc_state, _ = trainer.create_states()
        g, d, logs = trainer.grads(gen_state, disc_state, SEED, frames.to(device))
        torch.save({"frames": frames, "gen": torch.cat([t.reshape(-1) for t in g]).cpu(),
                    "disc": torch.cat([t.reshape(-1) for t in d]).cpu(),
                    "logs": {k: float(v) for k, v in logs.items()}},
                   os.path.join(root, "vae_reference.pt"))
        del trainer, gen_state, disc_state, g, d
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with open(os.path.join(root, "plan.json"), "w") as f:
            json.dump({"device": str(device), "port": free_port(), "port2": free_port(),
                       "nccl_backend": "nccl" if device.type == "cuda" else "gloo",
                       "per": per}, f)
        t0 = time.perf_counter()
        children = run_ranks("ddp", root, "ddp", DDP_TIMEOUT_S, device)
        res = []
        for r in range(2):
            with open(os.path.join(root, f"ddp{r}.json")) as f:
                res.append(json.load(f))
        for name in ("ddp_train", "ddp_align", "ddp_vae", "ddp_nccl"):
            line = {"phase": name, **res[0][name], "card": smi}
            if name in res[1]:
                line["rank1"] = {k: v for k, v in res[1][name].items()
                                 if k in ("launches", "ms_per_micro_step", "all_reduce_ms_and_bytes",
                                          "seconds", "failed")}
            if name != "ddp_nccl":
                line["ms_are"] = "two ranks sharing one card: not scaling"
            emit(line)
            failed = list(res[0][name]["failed"]) + list(res[1].get(name, {}).get("failed", []))
            if failed:
                fail(f"{name}: {failed}")
            launches[name] = res[0][name]["launches"]
    emit({"phase": "ddp_all", "seconds": time.perf_counter() - t_all, **children,
          "reference_seconds": t0 - t_all, "rank_stages_s": [r["stages_s"] for r in res],
          "rank_peak_gib_by_stage": [r["peak_gib_by_stage"] for r in res], "card": smi})
    return launches


def ddp_child(root: str, rank: int) -> int:
    """One rank of ``ddp_phases`` (``--ddp-child ROOT RANK``): its results in
    ``ROOT/ddp{RANK}.json``; a failed check is listed there, an error exits
    non-zero."""
    import torch
    import torch.distributed as dist
    from prediff_torch.cli import train_sevirlr_prediff as tp
    from prediff_torch.config import (alignment_default_config, load_config,
                                      prediff_default_config, vae_training_default_config)
    from prediff_torch.diffusion.knowledge_alignment import avg_x_objective
    from prediff_torch.factory import (build_alignment_trainer, build_training_pipeline,
                                       build_vae_trainer)
    from prediff_torch.parallel import all_reduce_mean, init_distributed, make_mesh
    from prediff_torch.parallel.mesh import gather_parts
    from prediff_torch.training import (alignment_trainer, diffusion_trainer, losses,
                                        vae_trainer)
    from prediff_torch.training.diffusion_trainer import step_dropout_seed, step_generator
    from prediff_torch.utils.device import set_numerics
    from prediff_torch.utils.distributions import DiagonalGaussianDistribution

    stages = {"imports": time.perf_counter() - T0}   # seconds since the process started

    def stage(name):
        sync(device)
        stages[name] = time.perf_counter() - T0
        progress(device, name, stages[name], peaks)

    with open(os.path.join(root, "plan.json")) as f:
        plan = json.load(f)
    device = torch.device(plan["device"])
    rank_memory_share(device)
    per = plan["per"]
    cfg = load_config(prediff_default_config, os.path.join(root, "cfg.yaml"))
    weights = torch.load(os.path.join(root, "weights.pt"))
    set_numerics()
    counters, spy = kernel_counters(), plain_spy()
    peaks = {}   # stage -> GiB allocated and reserved at most since the stage before
    out = {"stages_s": stages, "peak_gib_by_stage": peaks}
    init_distributed(coordinator_address=f"localhost:{plan['port']}", num_processes=2,
                     process_id=rank, backend="gloo", device=device, timeout=120.0)
    mesh = make_mesh()
    world = mesh.size
    stage("joined")

    def flat(ts):
        return torch.cat([t.reshape(-1) for t in ts])

    def same_on_ranks(tensors) -> bool:
        digests = gather_parts(bit_digest(tensors).to(device), mesh)
        return all(torch.equal(digests[0], x) for x in digests[1:])

    def timed_reduce(module, ms):
        """``module.all_reduce_mean`` timed (synchronized) into ``ms`` as
        [ms, bytes] (the gradients' bucket and the losses' alike)."""
        def timed(tensors, m):
            sync(device)
            t0 = time.perf_counter()
            result = all_reduce_mean(tensors, m)
            sync(device)
            if m is not None:
                ms.append([1e3 * (time.perf_counter() - t0),
                           sum(t.numel() * t.element_size() for t in tensors)])
            return result
        module.all_reduce_mean = timed

    def against_one_process(name, local, ref):
        """Local gradients bit-equal to one process's at the rank's batch, and
        their all-reduced mean bit-equal to the mean of both ranks' (the other
        rank's reference read from the disk)."""
        ref = flat(ref).cpu()
        torch.save(ref, os.path.join(root, f"{name}_ref{rank}.pt"))
        dist.barrier()
        other = torch.load(os.path.join(root, f"{name}_ref{1 - rank}.pt"))
        reduced = flat(all_reduce_mean(local, mesh)).cpu()
        local = flat(local).cpu()
        both = (ref + other) if rank == 0 else (other + ref)
        line = {"local_bit_equal_to_one_process": bool(torch.equal(local, ref)),
                "reduced_bit_equal_to_mean": bool(torch.equal(reduced, both / world)),
                "local_rel_l2_to_one_process": rel_l2_and_cosine([local], [ref])[0]}
        line["failed"] = [k for k in ("local_bit_equal_to_one_process",
                                      "reduced_bit_equal_to_mean") if not line[k]]
        return line

    def posterior_rows(moments, generator, rows, total, scale):
        """The rank's rows of a whole batch's posterior sample, drawn here
        apart from the trainers: the noise of every frame of ``total``
        samples, cut to ``rows``."""
        B, T = moments.shape[:2]
        post = DiagonalGaussianDistribution.from_parameters(
            moments.float().reshape((-1,) + tuple(moments.shape[2:])))
        eps = torch.randn((total * T,) + tuple(post.mean.shape[1:]), generator=generator,
                          device=device)[rows.start * T:rows.stop * T]
        z = scale * (post.mean + post.std * eps)
        return z.reshape((B, T) + tuple(z.shape[1:]))

    # ---- the diffusion trainer
    img, d = cfg.layout, cfg.model.diffusion
    B = 1
    rows = slice(rank * B, (rank + 1) * B)
    rs = torch.Generator().manual_seed(SEED + 51)
    xs = [torch.rand((B * world, img.out_len, img.img_height, img.img_width, img.data_channels),
                     generator=rs) for _ in range(DDP_TRAIN_MICRO)]
    ys = [torch.rand((B * world, img.in_len, img.img_height, img.img_width, img.data_channels),
                     generator=rs) for _ in range(DDP_TRAIN_MICRO)]
    ld = build_training_pipeline(cfg, device=device, params=weights)
    trainer = tp.make_trainer(cfg, ld, TRAIN_SCHEDULE_STEPS, DDP_ACCUM, latent_inputs=False,
                              mesh=mesh)
    state = trainer.create_state()
    stage("train_state")
    x0, y0 = xs[0][rows].to(device), ys[0][rows].to(device)
    local, _ = trainer.grads(state, SEED, x0, y0, reduce=False)
    gen = step_generator(SEED, 0, device)
    with torch.no_grad():
        z = posterior_rows(ld.first_stage_moments(x0.reshape((-1,) + tuple(x0.shape[2:])))
                           .reshape((B, img.out_len) + tuple(d.latent_shape[1:3]) + (-1,)),
                           gen, rows, B * world, ld.scale_factor)
        zc = ld.cond_stage_forward(y0)
    t = torch.randint(0, ld.num_timesteps, (B * world,), generator=gen, device=device)[rows]
    noise = torch.randn((B * world,) + tuple(z.shape[1:]), generator=gen, device=device)[rows]
    logvar = state.params["logvar"] if "logvar" in state.params else ld.init_logvar()
    loss, _ = ld.p_losses(logvar, z, zc, t, noise, dropout_seed=step_dropout_seed(SEED, 0),
                          dropout_first_row=rows.start)
    check = against_one_process("train", local, torch.autograd.grad(loss, list(
        state.params.values())))
    stage("train_checked")
    del local, loss
    reduce_ms = []
    timed_reduce(diffusion_trainer, reduce_ms)

    def train():
        nonlocal state
        micro_ms, equal = [], []
        for i in range(DDP_TRAIN_MICRO):
            sync(device)
            t1 = time.perf_counter()
            state, _ = trainer.train_step(state, SEED, xs[i][rows].to(device),
                                          ys[i][rows].to(device))
            sync(device)
            micro_ms.append(1e3 * (time.perf_counter() - t1))
            equal.append(same_on_ranks(state.tensors()))
        line = {**check, "ranks": world, "backend": mesh.backend, "samples_per_rank": B,
                "accum_steps": DDP_ACCUM, "micro_steps": DDP_TRAIN_MICRO,
                "optimizer_steps": state.tx.count, "ms_per_micro_step": micro_ms,
                "all_reduce_ms_and_bytes": list(reduce_ms), "ranks_bit_equal_after_each_step": equal,
                "gradient_bytes": 4 * sum(p.numel() for p in state.params.values())}
        if not all(equal):
            line["failed"].append(f"the ranks' states differ after a micro-step: {equal}")
        return line

    per_train = {k: v["per_train"] for k, v in per.items()}
    out["ddp_train"] = counted_phase(
        device, counters, spy, train,
        lambda line: expected_train_launches(per_train, DDP_TRAIN_MICRO, 0, True))
    stage("train_done")
    del trainer, state, ld
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the alignment trainer
    acfg = load_config(alignment_default_config, os.path.join(root, "align.yaml"))
    atrainer = build_alignment_trainer(acfg, device=device, seed=SEED, mesh=mesh)
    astate = atrainer.create_state()
    ax = [torch.rand((world, acfg.layout.out_len, acfg.layout.img_height,
                      acfg.layout.img_width, 1), generator=rs) for _ in range(DDP_ALIGN_STEPS)]
    ay = [torch.rand((world, acfg.layout.in_len, acfg.layout.img_height,
                      acfg.layout.img_width, 1), generator=rs) for _ in range(DDP_ALIGN_STEPS)]
    x0, y0 = ax[0][rows].to(device), ay[0][rows].to(device)
    local, _ = atrainer.grads(astate, SEED, x0, y0, reduce=False)
    gen = step_generator(SEED, 0, device)
    with torch.no_grad():
        moments = atrainer.vae.encode_moments(x0.reshape((-1,) + tuple(x0.shape[2:])))
        z = posterior_rows(moments.reshape((B, -1) + tuple(moments.shape[1:])), gen, rows,
                           world, atrainer.scale_factor)
    t = torch.randint(0, atrainer.schedule.num_timesteps, (world,), generator=gen,
                      device=device)[rows]
    noise = torch.randn((world,) + tuple(z.shape[1:]), generator=gen, device=device)[rows]
    loss, _ = atrainer.p_losses(z, t, noise, avg_x_objective(x0),
                                dropout_seed=step_dropout_seed(SEED, 0),
                                dropout_first_row=rows.start)
    check = against_one_process("align", local,
                                torch.autograd.grad(loss, list(astate.params.values())))
    reduce_ms = []
    timed_reduce(alignment_trainer, reduce_ms)

    def align():
        nonlocal astate
        step_ms, equal = [], []
        for i in range(DDP_ALIGN_STEPS):
            sync(device)
            t1 = time.perf_counter()
            astate, _ = atrainer.train_step(astate, SEED, ax[i][rows].to(device),
                                            ay[i][rows].to(device))
            sync(device)
            step_ms.append(1e3 * (time.perf_counter() - t1))
            equal.append(same_on_ranks(astate.tensors()))
        line = {**check, "ranks": world, "samples_per_rank": B, "steps": DDP_ALIGN_STEPS,
                "ms_per_micro_step": step_ms, "all_reduce_ms_and_bytes": list(reduce_ms),
                "ranks_bit_equal_after_each_step": equal}
        if not all(equal):
            line["failed"].append(f"the ranks' states differ after a step: {equal}")
        return line

    out["ddp_align"] = counted_phase(
        device, counters, spy, align,
        lambda line: align_train_launches(per, DDP_ALIGN_STEPS, dropout=True))
    stage("align_done")
    del atrainer, astate
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the VAE-GAN
    vcfg = load_config(vae_training_default_config, os.path.join(root, "vae.yaml"))
    ref = torch.load(os.path.join(root, "vae_reference.pt"))
    vrows = slice(rank * DDP_VAE_FRAMES // world, (rank + 1) * DDP_VAE_FRAMES // world)
    frames = ref["frames"][vrows].to(device)
    vtrainer = build_vae_trainer(vcfg, device=device, seed=SEED, mesh=mesh)
    gen_state, disc_state, stats = vtrainer.create_states()
    stage("vae_state")

    def vae_rel():
        g, dg, logs = vtrainer.grads(gen_state, disc_state, SEED, frames)
        return (rel_l2_and_cosine([flat(g).cpu()], [ref["gen"]])[0],
                rel_l2_and_cosine([flat(dg).cpu()], [ref["disc"]])[0],
                {k: float(v) for k, v in logs.items()})

    gen_rel, disc_rel, logs = vae_rel()
    reduce_sum = losses.all_reduce_sum_grad
    kept = {k: v.clone() for k, v in stats.items()}
    losses.all_reduce_sum_grad = lambda t, m: t * m.size   # each rank's own statistics
    try:
        gen_rel_local, disc_rel_local, _ = vae_rel()
    finally:
        losses.all_reduce_sum_grad = reduce_sum
        for k, v in kept.items():   # the control's own statistics do not stay
            stats[k].copy_(v)
    reduce_ms = []
    timed_reduce(vae_trainer, reduce_ms)

    def vae():
        nonlocal gen_state, disc_state, stats
        step_ms, equal = [], []
        for _ in range(DDP_VAE_STEPS):
            sync(device)
            t1 = time.perf_counter()
            gen_state, disc_state, stats, _ = vtrainer.train_step(gen_state, disc_state, stats,
                                                                  SEED, frames)
            sync(device)
            step_ms.append(1e3 * (time.perf_counter() - t1))
            equal.append(same_on_ranks(gen_state.tensors() + disc_state.tensors()
                                       + list(stats.values())))
        worst = max(abs(logs[k] - v) / max(abs(v), 1e-30) for k, v in ref["logs"].items())
        line = {"ranks": world, "frames_per_rank": frames.shape[0], "disc_start": 0,
                "gen_rel_l2_vs_one_process": gen_rel, "disc_rel_l2_vs_one_process": disc_rel,
                "logs_worst_rel_vs_one_process": worst,
                "no_reduce_gen_rel_l2": gen_rel_local, "no_reduce_disc_rel_l2": disc_rel_local,
                "tol_rel_l2": DDP_VAE_TOL_REL_L2, "steps": DDP_VAE_STEPS,
                "ms_per_micro_step": step_ms, "all_reduce_ms_and_bytes": list(reduce_ms),
                "ranks_bit_equal_after_each_step": equal, "failed": []}
        if not (gen_rel <= DDP_VAE_TOL_REL_L2 and disc_rel <= DDP_VAE_TOL_REL_L2):
            line["failed"].append(f"reduced gradients {gen_rel} / {disc_rel} from one process")
        if not max(gen_rel_local, disc_rel_local) > DDP_VAE_TOL_REL_L2:
            line["failed"].append("without the statistics' all-reduce the gradients are within "
                                  "the bar too: the bar tells nothing")
        if not all(equal):
            line["failed"].append(f"the ranks' states differ after a step: {equal}")
        return line

    out["ddp_vae"] = counted_phase(device, counters, spy, vae, lambda line: {})
    stage("vae_done")
    del vtrainer, gen_state, disc_state, stats
    if device.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()

    if rank == 0:   # a group of one rank on NCCL: a micro-step with the mesh and without
        init_distributed(coordinator_address=f"localhost:{plan['port2']}", num_processes=1,
                         process_id=0, backend=plan["nccl_backend"], device=device,
                         timeout=120.0)
        ld = build_training_pipeline(cfg, device=device, params=weights)
        x, y = xs[0][:1].to(device), ys[0][:1].to(device)

        def step(m):
            ld.unet.load_state_dict(weights["unet"])
            tr = tp.make_trainer(cfg, ld, TRAIN_SCHEDULE_STEPS, 1, latent_inputs=False, mesh=m)
            st = tr.create_state()
            st, loss_dict = tr.train_step(st, SEED, x, y)
            return bit_digest(st.tensors()).cpu(), float(loss_dict["train/loss"])

        def nccl():
            with_mesh, loss_mesh = step(make_mesh())
            without, loss_one = step(None)
            ok = torch.equal(with_mesh, without) and loss_mesh == loss_one
            return {"ranks": 1, "backend": plan["nccl_backend"], "micro_steps": 2,
                    "bit_equal_to_no_mesh": ok, "loss": loss_mesh,
                    "note": "one card holds one NCCL rank: its all-reduce is the identity",
                    "failed": [] if ok else ["the step on the mesh differs from one without"]}

        out["ddp_nccl"] = counted_phase(
            device, counters, spy, nccl,
            lambda line: expected_train_launches(per_train, 2, 0, True))
        dist.destroy_process_group()
        stage("nccl_done")
    with open(os.path.join(root, f"ddp{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def ddp_alone(device, smi):
    """``--only ddp``: the randomized full-width models as ``run`` makes them,
    then the ``ddp_*`` phases."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(cfg), gen, randomize=True)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    weights = {key: m.state_dict() for key, m in models.items()}
    ddp_phases(device, smi, cfg, weights, path_launches(models["unet"], models["align"]))


def mesh_alone(device, smi):
    """``--only mesh``: the randomized full-width models as ``run`` makes
    them, then the ``mesh_*`` phases."""
    import torch
    from prediff_torch.config import prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_

    cfg = prediff_default_config()
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(cfg), gen, randomize=True)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    weights = {key: m.state_dict() for key, m in models.items()}
    mesh_phases(device, smi, cfg, weights, path_launches(models["unet"], models["align"]),
                diagnose=True)


if __name__ == "__main__":
    sys.exit(main())
