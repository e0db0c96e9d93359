#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card
    python3 chip_smoke.py --log build/chip_smoke.jsonl   # also keep every line there

Phases, one JSON line each: the card; the kernels' build from
``prediff_torch/csrc``; each hand-written kernel against its plain PyTorch
version at every shape the UNet and the alignment net give it, with times;
a full-width UNet forward on the card (kernels) against the same forward on
the CPU (plain versions) with randomized weights; the guidance shift of the
full-width alignment net on the card against the CPU's; then three chains
through ``PreDiffPredictor.predict``, each with the kernels' launch counts
set to 0 just before it and read just after: the 100-step unguided DDPM
forecast, the 100-step guided DDPM forecast and the 50-step guided DDIM
forecast (VAE encode, the steps, VAE decode); profiles of a UNet forward
and of a guided step.  Then the ``kernels`` summary line, the card's name
and power limit, and as the last line ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero before that line is printed.
"""
import argparse
import json
import subprocess
import sys
import time

# Published peaks of one H100 SXM (dense): HBM 3.35 TB/s, bf16 tensor cores
# 989 TFLOP/s, f32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

CHAIN_STEPS = 100
SEED = 0
AVG_X_GT = 0.5          # the knowledge target of the guided chains
SHIFT_TOL_REL_L2 = 5e-2  # card vs CPU guidance shift (tests/test_guidance_kernels.py bar)
SHIFT_MIN_COSINE = 0.99

KERNELS = {  # name: (source, TPU kernel it replaces)
    "groupnorm_silu": ("prediff_torch/csrc/groupnorm.cu", "prediff_tpu/ops/pallas_groupnorm.py:127"),
    "ffn": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:126"),
    "axial_attention": ("prediff_torch/csrc/attention.cu",
                        "prediff_tpu/ops/pallas_attention.py:778"),
    "ffn_bwd_dx": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:445"),
    "axial_attention_bwd_dx": ("prediff_torch/csrc/attention.cu",
                               "prediff_tpu/ops/pallas_attention.py:927"),
    "resblock": ("prediff_torch/csrc/resblock.cu", "prediff_tpu/ops/pallas_resblock.py:458"),
    "resblock_bwd": ("prediff_torch/csrc/resblock.cu", "prediff_tpu/ops/pallas_resblock.py:530"),
}


LOG = []  # open files that every emitted line is also written to


def emit(obj) -> None:
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


def bound(bytes_moved: float, bf16_flops: float = 0.0, f32_flops: float = 0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = bf16_flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def errors(got, want):
    err = (got.double() - want.double()).abs()
    return float(err.max()), float(err.max() / want.double().abs().max().clamp_min(1e-30)), float(err.mean())


# --------------------------------------------------------------------------- #
def kernel_cases(unet, align):
    """Every (kernel, shape) of the paths, with launches per UNet forward
    (``per_unet``) and per guidance shift, alignment forward and backward
    (``per_align``)."""
    cases = {k: [] for k in KERNELS}

    def add(name, per_unet=0, per_align=0, **shape):
        cases[name].append(dict(shape, per_unet=per_unet, per_align=per_align))

    T, H, W, C0 = unet.mem_shapes[0]
    fp = unet.first_proj
    add("groupnorm_silu", per_unet=1, shape=[1, T * H * W, unet.data_shape[-1]],
        groups=fp.in_groups, emb=False)
    add("groupnorm_silu", per_unet=1, shape=[1, T * H * W, C0], groups=fp.out_groups, emb=False)
    for i, (t, h, w, c) in enumerate(unet.mem_shapes):
        n = unet.depth[i] * 2  # down + up calls of the stage's time blocks
        groups = unet.down_time_embed_blocks[i].in_groups
        add("groupnorm_silu", per_unet=n, shape=[1, t * h * w, c], groups=groups, emb=False)
        add("groupnorm_silu", per_unet=n, shape=[1, t * h * w, c], groups=groups, emb=True)
        add("ffn", per_unet=3 * n, shape=[t * h * w, c])
        for axis in range(3):
            add("axial_attention", per_unet=n, shape=[1, t, h, w, c], axis=axis)

    T, H, W, Cin = align.input_shape
    fp = align.first_proj
    add("groupnorm_silu", per_align=1, shape=[1, T * H * W, Cin], groups=fp.in_groups, emb=False)
    add("groupnorm_silu", per_align=1, shape=[1, T * H * W, align.mem_shapes[0][-1]],
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
    return cases


def check_kernels(cases, device):
    """Each case: the kernel against its plain version (bf16 operands rounded
    at the same points) on the same inputs, the error, the times and the
    bound.  Adds its results to the case dicts; returns the failed cases."""
    import torch
    from prediff_torch.ops.attention import (axial_attention_bwd_dx_plain, axial_attention_plain,
                                             fused_axial_attention, fused_axial_attention_bwd_dx)
    from prediff_torch.ops.ffn import ffn_bwd_dx_plain, ffn_plain, fused_ffn, fused_ffn_bwd_dx
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu, groupnorm_silu_plain
    from prediff_torch.ops.resblock import (fused_resblock_bwd, fused_resblock_fwd,
                                            resblock_bwd_plain, resblock_plain)

    gen = torch.Generator(device=device).manual_seed(SEED)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    def vec(C, scale=0.1, shift=0.0):
        return randn(C, scale=scale, shift=shift)

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

    def timed(c, kernel, plain, nbytes, **flops):
        c.update(ms=time_ms(kernel), plain_ms=time_ms(plain), bound=bound(nbytes, **flops),
                 library_ms=None)

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
        timed(c, lambda: fused_groupnorm_silu(x, w, b, emb, groups),
              lambda: groupnorm_silu_plain(x, w, b, emb, groups),
              4 * (2 * B * N * C + 2 * C + (B * C if emb is not None else 0)),
              f32_flops=12 * B * N * C)

    for name, c in [(n, c) for n in ("ffn", "ffn_bwd_dx") for c in cases[n]]:
        M, C = c["shape"]
        hid = 4 * C
        x, ln_w, ln_b = randn(M, C), vec(C, shift=1.0), vec(C)
        w1, b1 = randn(hid, C, scale=C ** -0.5), vec(hid)
        w2, b2 = randn(C, hid, scale=hid ** -0.5), vec(C)
        if name == "ffn":
            args = (x, ln_w, ln_b, w1, b1, w2, b2)
            got, want = fused_ffn(*args), ffn_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want, tol=2e-2)
            timed(c, lambda: fused_ffn(*args), lambda: ffn_plain(*args, mxu_dtype=bf16),
                  4 * (2 * M * C + 2 * C * hid + hid + 3 * C), bf16_flops=4 * M * C * hid)
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
    for name, c in [(n, c) for n in ("axial_attention", "axial_attention_bwd_dx")
                    for c in cases[n]]:
        B, T, H, W, C = c["shape"]
        axis = c["axis"]
        vol = (T, H, W)[axis]
        M = B * T * H * W
        x, ln_w, ln_b = randn(B, T, H, W, C), vec(C, shift=1.0), vec(C)
        w_qkv, bias = randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5)
        w_proj, b_proj = randn(C, C, scale=C ** -0.5), vec(C)
        scale = (C // heads) ** -0.5
        if name == "axial_attention":
            args = (x, axis, ln_w, ln_b, w_qkv, bias, w_proj, b_proj, heads, scale)
            got = fused_axial_attention(*args)
            want = axial_attention_plain(*args, mxu_dtype=bf16)
            sync(device)
            judge(c, got, want, tol=2e-2)
            timed(c, lambda: fused_axial_attention(*args),
                  lambda: axial_attention_plain(*args, mxu_dtype=bf16),
                  4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C),
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
        timed(c_fwd, lambda: fused_resblock_fwd(*args, groups),
              lambda: resblock_plain(*args, groups, mxu_dtype=bf16),
              4 * 2 * M * C + 2 * M * C + weights + 4 * (B * C + 6 * C), bf16_flops=conv_flops)
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
              4 * 3 * M * C + 2 * M * C + weights + 4 * (2 * B * C + 4 * C),
              bf16_flops=conv_flops)

    for name, cs in cases.items():
        failed += [(name, c) for c in cs if not c["ok"]]
    return failed


def expected_launches(cases, steps: int, guided: bool):
    return {name: steps * sum(c["per_unet"] + (c["per_align"] if guided else 0) for c in cs)
            for name, cs in cases.items()}


def summarize(cases, launches_by_path, main_path: str):
    """The ``kernels`` line: per kernel, times weighted over one guided
    step's mix of shapes (launches per UNet forward plus per guidance shift)."""
    out = []
    for name, cs in cases.items():
        wts = [c["per_unet"] + c["per_align"] for c in cs]
        n = sum(wts)

        def mix(key, cs=cs, wts=wts, n=n):
            return sum(c[key] * w for c, w in zip(cs, wts)) / n

        bytes_share = sum(w for c, w in zip(cs, wts) if c["bound"][1] == "bytes") / n
        out.append(dict(
            name=name, route="cuda", source=KERNELS[name][0], replaces=KERNELS[name][1],
            launches=launches_by_path[main_path][name],
            max_abs_err=max(c["max_abs_err"] for c in cs), ms=mix("ms"), plain_ms=mix("plain_ms"),
            bound_ms=sum(c["bound"][0] * w for c, w in zip(cs, wts)) / n,
            bound_by="bytes" if bytes_share >= 0.5 else "operations", library_ms=None,
            launches_by_path={p: v[name] for p, v in launches_by_path.items()},
            launches_per_guided_step_mix=n,
            shapes=[{k: v for k, v in c.items() if k != "bound"}
                    | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1]} for c in cs]))
    return out


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


# --------------------------------------------------------------------------- #
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="also write every JSON line to this file")
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
        import os

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
          "ptxas": {k: [ln.strip() for ln in v["ptxas"].splitlines() if "Used" in ln or "spill" in ln]
                    for k, v in report.items()}})
    run(device, prediff_default_config(), smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def run(device, cfg, smi: str) -> None:
    """Every phase after the build, on ``device``; raises SystemExit on a failed check."""
    import torch
    from prediff_torch.diffusion.knowledge_alignment import KnowledgeAlignment
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.ops.attention import fused_axial_attention, fused_axial_attention_bwd_dx
    from prediff_torch.ops.ffn import fused_ffn, fused_ffn_bwd_dx
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu
    from prediff_torch.ops.resblock import fused_resblock_bwd, fused_resblock_fwd
    from prediff_torch.serving import PreDiffPredictor
    from prediff_torch.utils.device import set_numerics

    set_numerics()
    counters = {"groupnorm_silu": fused_groupnorm_silu, "ffn": fused_ffn,
                "axial_attention": fused_axial_attention, "ffn_bwd_dx": fused_ffn_bwd_dx,
                "axial_attention_bwd_dx": fused_axial_attention_bwd_dx,
                "resblock": fused_resblock_fwd, "resblock_bwd": fused_resblock_bwd}
    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    align_cpu = init_params_(build_alignment_model(cfg), gen,
                             randomize=True).eval().requires_grad_(False)
    emit({"phase": "weights", "randomized": True, "seed": SEED,
          "unet_params": sum(p.numel() for p in unet_cpu.parameters()),
          "vae_params": sum(p.numel() for p in vae_cpu.parameters()),
          "align_params": sum(p.numel() for p in align_cpu.parameters())})

    cases = kernel_cases(unet_cpu, align_cpu)
    bad = check_kernels(cases, device)
    emit({"phase": "kernels_vs_plain", "cases": sum(len(v) for v in cases.values()),
          "failed": len(bad)})
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    predictor = PreDiffPredictor(cfg, params={"unet": unet_cpu.state_dict(),
                                              "vae": vae_cpu.state_dict(),
                                              "align": align_cpu.state_dict()},
                                 with_alignment=True, device=device)

    # Denoise forward at full width: the card (kernels) against the CPU (plain, f32).
    rs = torch.Generator().manual_seed(SEED + 1)
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
    emit({"phase": "denoise_forward", "shape": list(got.shape), "rel_l2_err": rel_l2,
          "max_abs_err": max_abs, "ref_max_abs": float(ref.abs().max()), "tol_rel_l2": fwd_tol,
          "cpu_forward_s": cpu_s})
    if not torch.isfinite(got).all() or rel_l2 > fwd_tol:
        fail(f"card forward differs from the CPU forward: rel_l2 {rel_l2}")

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    # The guidance shift at full width: the card (kernels, their autograd
    # Functions) against the CPU (plain versions, f32).  A kernel invisible to
    # autograd would leave only the residual paths and fail this.
    avg = torch.tensor([[AVG_X_GT]])
    z = torch.randn((1,) + tuple(cfg.model.align.model_args.input_shape), generator=rs)
    ka_cpu = KnowledgeAlignment(align_cpu, guide_scale=cfg.model.align.guide_scale)
    t1 = time.perf_counter()
    shift_cpu = ka_cpu.get_mean_shift(z, t, avg)
    cpu_s = time.perf_counter() - t1
    predictor.ld.alignment.get_mean_shift(z.to(device), t.to(device), avg.to(device))
    sync(device)
    zero_counts()
    shift_card = predictor.ld.alignment.get_mean_shift(z.to(device), t.to(device),
                                                       avg.to(device)).cpu()
    shift_counts = read_counts()
    want_counts = {k: sum(c["per_align"] for c in cs) for k, cs in cases.items()}
    rel_l2 = float((shift_card - shift_cpu).norm() / shift_cpu.norm())
    cosine = float((shift_card * shift_cpu).sum() / (shift_card.norm() * shift_cpu.norm()))
    emit({"phase": "guided_shift", "shape": list(shift_card.shape), "rel_l2_err": rel_l2,
          "cosine": cosine, "tol_rel_l2": SHIFT_TOL_REL_L2, "min_cosine": SHIFT_MIN_COSINE,
          "cpu_max_abs": float(shift_cpu.abs().max()), "cpu_shift_s": cpu_s,
          "launches": shift_counts, "expected_launches": want_counts})
    if not torch.isfinite(shift_card).all() or rel_l2 > SHIFT_TOL_REL_L2 or cosine < SHIFT_MIN_COSINE:
        fail(f"card guidance shift differs from the CPU's: rel_l2 {rel_l2}, cosine {cosine}")
    if shift_counts != want_counts:
        fail(f"guidance shift launches {shift_counts} != expected {want_counts}")

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
    launches_by_path, ms_per_step = {}, {}
    for phase, (kw, steps, guided) in chains.items():
        warm = dict(kw, **({"ddim_steps": 2} if "ddim_steps" in kw else {"timesteps": 2}))
        predictor.predict(context, generator=torch.Generator(device).manual_seed(1), **warm)
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_counts()
        t1 = time.perf_counter()
        out = predictor.predict(context, generator=torch.Generator(device).manual_seed(SEED), **kw)
        sync(device)
        chain_s = time.perf_counter() - t1
        launches = read_counts()
        expected = expected_launches(cases, steps, guided)
        launches_by_path[phase] = launches
        ms_per_step[phase] = 1e3 * chain_s / steps
        line = {"phase": phase, "steps": steps, "shape": list(out.shape),
                "finite": bool(torch.isfinite(out).all()), "seconds": chain_s,
                "ms_per_step": ms_per_step[phase], "steps_per_s": steps / chain_s,
                "launches": launches, "expected_launches": expected, "card": smi,
                "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30}
        if guided:
            line["guidance_share_of_step"] = 1.0 - ms_per_step["forecast"] / ms_per_step[phase]
        emit(line)
        if tuple(out.shape) != expect_shape or not torch.isfinite(out).all():
            fail(f"{phase}: shape {tuple(out.shape)} (want {expect_shape}) or non-finite values")
        if launches != expected:
            fail(f"{phase}: kernel launches {launches} != expected {expected}")

    xd, td, cd = x.to(device), t.to(device), cond.to(device)
    emit(profile("profile_unet_forward", lambda: predictor.ld.unet(xd, td, cd), reps=5))
    zc = predictor.ld.cond_stage_forward(context.to(device))
    zg = torch.randn((1,) + tuple(d.latent_shape), device=device)
    avg_d = avg.to(device)
    emit(profile("profile_guided_step",
                 lambda: predictor.ld.p_sample_step(zg, predictor.ld.num_timesteps // 2, zc,
                                             1.0, None, avg_x_gt=avg_d),
                 reps=5))
    emit(profile("profile_guidance_shift",
                 lambda: predictor.ld.alignment.get_mean_shift(zg, td, avg_d), reps=5))
    emit({"kernels": summarize(cases, launches_by_path, "guided_forecast")})
    print(smi, flush=True)


if __name__ == "__main__":
    sys.exit(main())
