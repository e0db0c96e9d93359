#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one CUDA card

Phases, one JSON line each: the card; the kernels' build from
``prediff_torch/csrc``; each hand-written kernel against its plain PyTorch
version at every shape the main path gives it, with times; a full-width
UNet forward on the card (kernels) against the same forward on the CPU
(plain versions) with randomized weights; the 100-step unguided DDPM
forecast (VAE encode, 100 UNet steps, VAE decode) through
``PreDiffPredictor.predict``, with the kernels' launch counts.  Then the
``kernels`` summary line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line is printed.
"""
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
def kernel_cases(unet):
    """Every (kernel, shape) the UNet forward launches, with launches per forward."""
    mem = unet.mem_shapes
    T, H, W, C0 = mem[0]
    gn, ffn, attn = [], [], []
    fp = unet.first_proj
    gn.append(((1, T * H * W, unet.data_shape[-1]), fp.in_groups, False, 1))
    gn.append(((1, T * H * W, C0), fp.out_groups, False, 1))
    for i, (t, h, w, c) in enumerate(mem):
        n = unet.depth[i] * 2  # down + up calls of the stage's time blocks
        groups = unet.down_time_embed_blocks[i].in_groups
        gn.append(((1, t * h * w, c), groups, False, n))
        gn.append(((1, t * h * w, c), groups, True, n))
        ffn.append(((t * h * w, c), 3 * n))
        for axis in range(3):
            attn.append(((1, t, h, w, c), axis, n))
    return gn, ffn, attn


def check_kernels(unet, device):
    import torch
    from prediff_torch.ops.attention import axial_attention_plain, fused_axial_attention
    from prediff_torch.ops.ffn import ffn_plain, fused_ffn
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu, groupnorm_silu_plain

    gen = torch.Generator(device=device).manual_seed(SEED)

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=device) * scale + shift

    gn_cases, ffn_cases, attn_cases = kernel_cases(unet)
    bf16 = torch.bfloat16
    results = {"groupnorm_silu": [], "ffn": [], "axial_attention": []}

    # GN: no matmul, f32 both ways; only the sum order differs.
    for (B, N, C), groups, with_emb, per_fwd in gn_cases:
        x = randn(B, N, C, scale=2.0, shift=1.0)
        w, b = randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1)
        emb = randn(B, C) if with_emb else None
        got = fused_groupnorm_silu(x, w, b, emb, groups)
        want = groupnorm_silu_plain(x, w, b, emb, groups)
        sync(device)
        e = errors(got, want)
        nbytes = 4 * (2 * B * N * C + 2 * C + (B * C if with_emb else 0))
        results["groupnorm_silu"].append(dict(
            shape=[B, N, C], groups=groups, emb=with_emb, per_forward=per_fwd,
            max_abs_err=e[0], max_rel_err=e[1], tol=1e-4, ok=e[0] <= 1e-4,
            ms=time_ms(lambda: fused_groupnorm_silu(x, w, b, emb, groups)),
            plain_ms=time_ms(lambda: groupnorm_silu_plain(x, w, b, emb, groups)),
            bound=bound(nbytes, f32_flops=12 * B * N * C)))

    # FFN and attention: bf16 operands rounded at the same points on both
    # sides; a flipped rounding moves a few outputs by up to ~1e-2.
    tol_bf16 = 2e-2
    for (M, C), per_fwd in ffn_cases:
        hid = 4 * C
        args = (randn(M, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1),
                randn(hid, C, scale=C ** -0.5), randn(hid, scale=0.1),
                randn(C, hid, scale=hid ** -0.5), randn(C, scale=0.1))
        got = fused_ffn(*args)
        want = ffn_plain(*args, mxu_dtype=bf16)
        sync(device)
        e = errors(got, want)
        results["ffn"].append(dict(
            shape=[M, C, hid], per_forward=per_fwd, max_abs_err=e[0], max_rel_err=e[1],
            mean_abs_err=e[2], tol=tol_bf16, ok=e[0] <= tol_bf16,
            ms=time_ms(lambda: fused_ffn(*args)),
            plain_ms=time_ms(lambda: ffn_plain(*args, mxu_dtype=bf16)),
            bound=bound(4 * (2 * M * C + 2 * C * hid + hid + 3 * C), bf16_flops=4 * M * C * hid)))

    for (B, T, H, W, C), axis, per_fwd in attn_cases:
        heads = 4
        vol = (T, H, W)[axis]
        M = B * T * H * W
        args = (randn(B, T, H, W, C), randn(C, scale=0.1, shift=1.0), randn(C, scale=0.1),
                randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
                randn(C, C, scale=C ** -0.5), randn(C, scale=0.1))
        scale = (C // heads) ** -0.5
        got = fused_axial_attention(args[0], axis, *args[1:], heads, scale)
        want = axial_attention_plain(args[0], axis, *args[1:], heads, scale, mxu_dtype=bf16)
        sync(device)
        e = errors(got, want)
        results["axial_attention"].append(dict(
            shape=[B, T, H, W, C], axis=axis, heads=heads, per_forward=per_fwd,
            max_abs_err=e[0], max_rel_err=e[1], mean_abs_err=e[2], tol=tol_bf16,
            ok=e[0] <= tol_bf16,
            ms=time_ms(lambda: fused_axial_attention(args[0], axis, *args[1:], heads, scale)),
            plain_ms=time_ms(lambda: axial_attention_plain(args[0], axis, *args[1:], heads,
                                                           scale, mxu_dtype=bf16)),
            bound=bound(4 * (2 * M * C + 4 * C * C + heads * vol * vol + 3 * C),
                        bf16_flops=8 * M * C * C + 4 * M * vol * C)))
    return results


def summarize(results, launches):
    meta = {
        "groupnorm_silu": ("prediff_torch/csrc/groupnorm.cu",
                           "prediff_tpu/ops/pallas_groupnorm.py:127"),
        "ffn": ("prediff_torch/csrc/ffn.cu", "prediff_tpu/ops/pallas_ffn.py:126"),
        "axial_attention": ("prediff_torch/csrc/attention.cu",
                            "prediff_tpu/ops/pallas_attention.py:778"),
    }
    out = []
    for name, cases in results.items():
        n = sum(c["per_forward"] for c in cases)

        def per_launch(key, cases=cases, n=n):
            return sum(c[key] * c["per_forward"] for c in cases) / n

        bound_ms = sum(c["bound"][0] * c["per_forward"] for c in cases) / n
        bytes_share = sum(c["per_forward"] for c in cases if c["bound"][1] == "bytes") / n
        out.append(dict(
            name=name, route="cuda", source=meta[name][0], replaces=meta[name][1],
            launches=launches[name], max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=per_launch("ms"), plain_ms=per_launch("plain_ms"), bound_ms=bound_ms,
            bound_by="bytes" if bytes_share >= 0.5 else "operations", library_ms=None,
            per_launch_mix_of_one_forward=n,
            shapes=[{k: v for k, v in c.items() if k != "bound"}
                    | {"bound_ms": c["bound"][0], "bound_by": c["bound"][1], "library_ms": None}
                    for c in cases]))
    return out


def profile_forward(unet, x, t, cond, reps: int = 5):
    """Device time by kernel over ``reps`` UNet forwards (torch.profiler), and
    the device's busy share of the window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        unet(x, t, cond)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                unet(x, t, cond)
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
    return {"phase": "profile_unet_forward", "reps": reps, "wall_ms_per_forward": wall_ms / reps,
            "device_ms_per_forward": busy, "device_busy_share": busy * reps / wall_ms,
            "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]} for r in rows[:20]]}


# --------------------------------------------------------------------------- #
def main() -> int:
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
    from prediff_torch.factory import build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.ops.attention import fused_axial_attention
    from prediff_torch.ops.ffn import fused_ffn
    from prediff_torch.ops.groupnorm import fused_groupnorm_silu
    from prediff_torch.serving import PreDiffPredictor

    gen = torch.Generator().manual_seed(SEED)
    unet_cpu = init_params_(build_unet(cfg), gen, randomize=True).eval().requires_grad_(False)
    vae_cpu = init_params_(build_vae(cfg), gen, randomize=True).eval().requires_grad_(False)
    emit({"phase": "weights", "randomized": True, "seed": SEED,
          "unet_params": sum(p.numel() for p in unet_cpu.parameters()),
          "vae_params": sum(p.numel() for p in vae_cpu.parameters())})

    results = check_kernels(unet_cpu, device)
    bad = [(k, c) for k, cs in results.items() for c in cs if not c["ok"]]
    emit({"phase": "kernels_vs_plain", "cases": sum(len(v) for v in results.values()),
          "failed": len(bad)})
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    predictor = PreDiffPredictor(cfg, params={"unet": unet_cpu.state_dict(),
                                              "vae": vae_cpu.state_dict()}, device=device)

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

    # The forecast: VAE encode, 100 denoise steps, VAE decode.
    img = cfg.layout
    context = torch.rand((1, img.in_len, img.img_height, img.img_width, img.data_channels),
                         generator=rs)
    predictor.predict(context, timesteps=2, generator=torch.Generator(device).manual_seed(1))
    sync(device)
    counters = {"groupnorm_silu": fused_groupnorm_silu, "ffn": fused_ffn,
                "axial_attention": fused_axial_attention}
    for fn in counters.values():
        fn.launches = 0
    t1 = time.perf_counter()
    out = predictor.predict(context, timesteps=CHAIN_STEPS,
                            generator=torch.Generator(device).manual_seed(SEED))
    sync(device)
    chain_s = time.perf_counter() - t1
    launches = {k: fn.launches for k, fn in counters.items()}
    per_forward = {k: sum(c["per_forward"] for c in v) for k, v in results.items()}
    expected = {k: n * CHAIN_STEPS for k, n in per_forward.items()}
    expect_shape = (1, img.out_len, img.img_height, img.img_width, img.data_channels)
    emit({"phase": "forecast", "steps": CHAIN_STEPS, "shape": list(out.shape),
          "finite": bool(torch.isfinite(out).all()), "seconds": chain_s,
          "ms_per_step": 1e3 * chain_s / CHAIN_STEPS, "steps_per_s": CHAIN_STEPS / chain_s,
          "launches": launches, "expected_launches": expected, "card": smi,
          "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                           if device.type == "cuda" else None)})
    if tuple(out.shape) != expect_shape or not torch.isfinite(out).all():
        fail(f"forecast shape {tuple(out.shape)} (want {expect_shape}) or non-finite values")
    if launches != expected:
        fail(f"kernel launches {launches} != expected {expected}")

    emit(profile_forward(predictor.ld.unet, x.to(device), t.to(device), cond.to(device)))
    emit({"kernels": summarize(results, launches)})
    print(smi, flush=True)


if __name__ == "__main__":
    sys.exit(main())
