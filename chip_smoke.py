#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card
    python3 chip_smoke.py --log build/chip_smoke.jsonl   # also keep every line there

Phases, one JSON line each: the card; the kernels' build from
``prediff_torch/csrc``; each hand-written kernel against its plain PyTorch
version at every shape the UNet (forecasting at B=1, training at the
micro-batch size) and the alignment net give it, with times; ``bwd_split``,
each launch's share of the all-gradients backwards at the training shapes
(GroupNorm+SiLU's too), of the general layer's dx and of the resblock;
the ``tiny_*`` phases on ``configs/tiny_smoke.yaml``, whose widths (16, 32)
every FFN, attention and resblock kernel refuses: a forecast, a guidance
shift and a training step at dropout 0 and 0.1, card against CPU, with no
launch of those kernels;
a full-width UNet forward on the card (kernels) against the same forward on
the CPU (plain versions) with randomized weights; the guidance shift of the
full-width alignment net on the card against the CPU's; then three chains
through ``PreDiffPredictor.predict``, each with the kernels' launch counts
set to 0 just before it and read just after: the 100-step unguided DDPM
forecast, the 100-step guided DDPM forecast and the 50-step guided DDIM
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
UNet forward and a guidance shift card against CPU, the 100-step unguided
and guided DDPM forecasts with exact launch counts, profiles; and for each
of ``PATTERN_CHECKS`` (depth [1,1]) a UNet forward and a guidance shift card
against CPU with exact launch counts.  Then
training.  ``train_rate0``, with the dropout rates at 0 and the UNet cut to
depth [1,1]: one loss and backward on the card (kernels) against the CPU
(plain, f32), then one accumulated optimizer step
through ``DiffusionTrainer.train_step``, which launches the all-gradients
kernels without dropout.  At the recipe's own rates (0.1) and full depth:
``train_grads``, one loss and backward of the UNet on the card (the dropout
kernels) against the CPU (plain, f32, the same masks regenerated from the same
seed), twice on the card for bit-equal gradients; ``train``, ``fit`` with
``DiffusionTrainer`` for a few accumulated optimizer steps from synthetic
batches with a validation step on the EMA weights (eval mode: no dropout) and
a checkpoint restored into a fresh state; a profile of one micro-step.  The
same four training phases then run on ``video_swin_1x8`` (``swin_train_rate0``
at depth [1,1], ``swin_train_grads``, ``swin_train``,
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
``conv_guided_forecast`` with exact counts, profiles; after ``train``,
``conv_train_grads``, ``conv_train`` and ``profile_conv_train_step`` (no
rate-0 phase).  Then the ``kernels`` summary line (per kernel its ms,
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

CHAIN_STEPS = 100
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


def ffn_library_seq(x, ln_w, ln_b, w1, b1, w2, b2, rate_act=0.0, rate_out=0.0):
    """The FFN as a sequence of library calls on pre-cast bf16 weights:
    ``F.layer_norm`` -> ``F.linear`` -> ``F.gelu`` (-> ``F.dropout``) ->
    ``F.linear`` (-> ``F.dropout``) -> + x."""
    import torch
    import torch.nn.functional as F

    bf16 = torch.bfloat16
    w1b, b1b, w2b, b2b = (t.to(bf16) for t in (w1, b1, w2, b2))
    C = x.shape[-1]

    def run():
        h = F.gelu(F.linear(F.layer_norm(x, (C,), ln_w, ln_b, 1e-5).to(bf16), w1b, b1b))
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


def ffn_library_bwd(x, g, ln_w, ln_b, w1, b1, w2, rate_act, rate_out, seed, site):
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
    h = F.gelu(F.linear(F.layer_norm(xl, (C,), lw, lb, 1e-5).to(bf16), w1l.to(bf16), b1l.to(bf16)))
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
    table = {**KERNELS, **BF16_KERNELS}
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
                                     "library_seq_ms", "library_seq_device_ms") if k in cs[0]}
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
PATH_WEIGHTS.update({"bf16_guidance_forecast": ("per_align",),
                     "conv_bf16_guidance_forecast": ("conv_per_align",)})
BF16_CHAIN_STEPS = 5            # the bf16 guided chain held card against CPU (temperature 0)
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
        got, want = fused_groupnorm_silu(x, w, b, None, groups), groupnorm_silu_plain(x, w, b,
                                                                                      None, groups)
        sync(device)
        judge_bf16(c, got, want, tol=1e-4)
        timed(c, lambda: fused_groupnorm_silu(x, w, b, None, groups),
              lambda: groupnorm_silu_plain(x, w, b, None, groups), 2 * 2 * B * N * C + 4 * 2 * C,
              device_time=True, library_seq=gn_library_seq(x, w, b, None, groups),
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
    """``conv_bf16_guidance_forecast``: the conv route's 100-step guided
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write every JSON line to this file")
    ap.add_argument("--only", type=lambda v: v.split(","),
                    help="comma-separated phases to run alone (after the device line and the "
                         f"build), then stop: {', '.join(ONLY)}")
    args = ap.parse_args()
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

    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG.append(open(args.log, "w"))
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: ptxas_by_function(v["ptxas"]) for k, v in report.items()}})
    if args.only:
        unknown = sorted(set(args.only) - set(ONLY))
        if unknown:
            print(f"chip_smoke: --only takes {', '.join(ONLY)}; not {unknown}", file=sys.stderr)
            return 2
        run_only(device, args.only, smi)
        print(smi, flush=True)
        return 0
    run(device, prediff_default_config(), smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


COUNTERS = {}   # kernel name -> its wrapper (kernel_counters)


def counters_zero():
    """Every wrapper's launch counts, its bf16 form's too, set to 0."""
    for fn in COUNTERS.values():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0


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
# eval (eval_suite) and data (data_prefetch)
ONLY = ("bwd_split", "guided_repeat", "vae_train", "align_train", "bf16", "vae_train_bf16",
        "eval", "data")


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
        if name == "bwd_split":
            bwd_split(device)
        elif name == "guided_repeat":
            guided_repeat(device)
        elif name == "vae_train":
            vae_train_phases(device, smi)
        elif name == "vae_train_bf16":
            vae_train_bf16_phases(device, smi)
        elif name == "bf16":
            bf16_alone(device, smi)
        else:
            cfg = alignment_default_config()
            per = path_launches(build_unet(prediff_default_config()), build_alignment_model(cfg),
                                cfg.optim.micro_batch_size)
            align_train_phases(device, smi, per, *kernel_counters())


def run(device, cfg, smi: str) -> None:
    """Every phase after the build, on ``device``; raises SystemExit on a failed check."""
    import torch
    from prediff_torch.config import alignment_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.device import set_numerics

    set_numerics()
    zero_counts, read_counts = kernel_counters()
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

    tiny_phases(device, zero_counts, read_counts)
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
    swin_launches, swin_unet = swin_phases(device, cfg, smi, cases, zero_counts, read_counts)
    launches_by_path.update(swin_launches)
    pattern_phases(device, cfg, zero_counts, read_counts)
    per_train = {k: v["per_train"] for k, v in by_route.items()}
    train_weights = {"unet": weights["unet"], "vae": weights["vae"]}
    launches_by_path.update(train_phases(device, cfg, smi, per_train, train_weights, zero_counts,
                                         read_counts))
    # the conv route in training: the recipe's rates (no rate-0 phase), B=2
    launches_by_path.update(train_phases(
        device, conv_config(cfg), smi, {k: v["per_train"] for k, v in conv_per.items()},
        train_weights, zero_counts, read_counts, prefix="conv_", rate0=False))
    launches_by_path.update(swin_train_phases(device, cfg, smi, swin_unet, vae_cpu.state_dict(),
                                              zero_counts, read_counts))
    vae_train_phases(device, smi)
    vae_train_bf16_phases(device, smi)
    launches_by_path["align_train"] = align_train_phases(device, smi, by_route, zero_counts,
                                                         read_counts)
    emit({"phase": "graph_chains", "card": smi, "chains": GRAPH_CHAINS})
    emit({"kernels": summarize({**cases, **bcases}, launches_by_path)})
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
    (the CPU takes the plain conv with the same bf16 rounding), the 100-step
    unguided and guided DDPM forecasts with exact counts, profiles of a UNet
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


def swin_phases(device, cfg, smi, cases, zero_counts, read_counts):
    """The forecasts with the non-axial cuboid pattern ``SWIN_PATTERN`` in the
    UNet and the alignment net, everything else as ``cfg``, weights random
    from the seed: the three cuboid kernels against their plain versions
    (``swin_kernels_vs_plain``; their cases join ``cases``), a UNet forward
    and a guidance shift card against CPU, the 100-step unguided and guided
    DDPM forecasts with exact launch counts, profiles of a UNet forward, a
    guided step and a guidance shift.  Returns the launches of the two chains
    and the UNet (CPU, random weights) the training phases start from."""
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    scfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"self_pattern": SWIN_PATTERN},
        "align": {"model_args": {"block_attn_patterns": SWIN_PATTERN}}}}))
    gen = torch.Generator().manual_seed(SEED)
    models = {key: init_params_(build(scfg), gen, randomize=True).eval().requires_grad_(False)
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
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
    return launches, unet_cpu


def swin_train_phases(device, cfg, smi, unet_cpu, vae_sd, zero_counts, read_counts):
    """The training phases (``train_phases``) on ``SWIN_PATTERN`` in the UNet:
    ``swin_train_rate0`` on a randomized UNet cut to depth [1,1],
    ``swin_train_grads``, ``swin_train`` and ``profile_swin_train_step`` at
    full depth from ``unet_cpu``'s weights.  Returns the launches of the
    rate-0 optimizer step and of the ``fit`` run."""
    from prediff_torch.config import ConfigDict, deep_merge

    scfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"self_pattern": SWIN_PATTERN}}}))
    per = {k: v["per_train"] for k, v in path_launches(unet_cpu).items()}
    return train_phases(device, scfg, smi, per, {"unet": unet_cpu.state_dict(), "vae": vae_sd},
                        zero_counts, read_counts, prefix="swin_")


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


def rate0_phases(card_vs_cpu, cfg, vae_sd, xy, device, zero_counts, read_counts, prefix):
    """``train_rate0`` (one loss and backward card against CPU) and
    ``train_rate0_step`` (one accumulated optimizer step) with the dropout
    rates at 0, on a randomized UNet of ``cfg`` cut to depth [1,1] (its counts
    from that model's routes).  Returns the step's launch counts."""
    import numpy as np
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
    from prediff_torch.factory import build_unet
    from prediff_torch.models.init import init_params_

    cfg0 = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {"latent_model": dict(
        depth=[1, 1], attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0, time_embed_dropout=0.0)}}))
    unet0 = init_params_(build_unet(cfg0), torch.Generator().manual_seed(SEED), randomize=True)
    per0 = {k: v["per_train"]
            for k, v in path_launches(unet0, train_batch=cfg.optim.micro_batch_size).items()}
    weights0 = {"unet": unet0.state_dict(), "vae": vae_sd}
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
    emit(profile(f"profile_{prefix}train_rate0_step",
                 lambda: trainer0.train_step(state0, SEED, *xy), reps=2))
    del ld0, trainer0, state0
    return launches0


def train_phases(device, cfg, smi, per_train, weights, zero_counts, read_counts, prefix="",
                 rate0=True):
    """``train_rate0`` (dropout rates 0, depth [1,1]: ``rate0_phases``; not
    run when ``rate0`` is False), then ``train_grads``, ``train`` and
    ``profile_train_step`` at the configuration's own rates, all at its
    widths and depth on ``device``, each phase's name after ``prefix``;
    ``per_train`` is ``path_launches``' count per micro-step of each kernel,
    ``weights`` the state dicts of "unet" and "vae".  Returns the kernels' launch
    counts of the ``train_rate0`` optimizer step and of the ``fit`` run."""
    import numpy as np
    import torch
    from prediff_torch.config import ConfigDict, deep_merge
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

    def make_trainer(ld, c):
        return DiffusionTrainer(ld, optim_config=dict(
            lr=c.optim.lr, total_num_steps=TRAIN_SCHEDULE_STEPS, method=c.optim.method,
            wd=c.optim.wd, betas=tuple(c.optim.betas), gradient_clip_val=c.optim.gradient_clip_val,
            warmup_percentage=c.optim.warmup_percentage,
            lr_scheduler_mode=c.optim.lr_scheduler_mode, min_lr_ratio=c.optim.min_lr_ratio,
            warmup_min_lr_ratio=c.optim.warmup_min_lr_ratio, accum_steps=TRAIN_ACCUM),
            use_ema=d.use_ema, track_grad_norm=True)

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

    # The recipe's rates, full depth: one loss and backward, the card against the CPU.
    per_micro = expected_train_launches(per_train, 1, 0, dropout=True)
    ld, trainer = card_vs_cpu(f"{prefix}train_grads", cfg, weights, DROP_SEED, per_micro)

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
    return dict(launches_by_phase, **{phase: launches})


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


if __name__ == "__main__":
    sys.exit(main())
