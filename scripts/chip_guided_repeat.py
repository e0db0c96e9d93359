#!/usr/bin/env python3
"""Does a guided forecast repeat bit for bit on the card?

    python3 scripts/chip_guided_repeat.py     # from the repository root, on one CUDA card

On configs/tiny_smoke.yaml at base_units 128 (widths the FFN, attention and
resblock kernels take), randomized weights, a 3-step guided DDPM forecast:
two eager chains, the captured chain twice, and two guidance shifts, first
with cuDNN's default algorithms, then with its deterministic ones.  Prints
one JSON line per setting: which pairs are bit-equal, the largest
difference between the two eager chains, and the cuDNN input-gradient
kernels one shift launches (by the profiler).
"""
import json
import os
import sys

import torch

sys.path.insert(0, ".")   # run from the repository root


def predictor(device):
    from prediff_torch.config import ConfigDict, deep_merge, load_config, prediff_default_config
    from prediff_torch.factory import build_alignment_model, build_unet, build_vae
    from prediff_torch.models.init import init_params_
    from prediff_torch.serving import PreDiffPredictor

    cfg = load_config(prediff_default_config, os.path.join("configs", "tiny_smoke.yaml"))
    cfg = ConfigDict.wrap(deep_merge(cfg.to_dict(), {"model": {
        "latent_model": {"base_units": 128}, "align": {"model_args": {"base_units": 128}}}}))
    gen = torch.Generator().manual_seed(0)
    params = {key: init_params_(build(cfg), gen, randomize=True).state_dict()
              for key, build in (("unet", build_unet), ("vae", build_vae),
                                 ("align", build_alignment_model))}
    return PreDiffPredictor(cfg, params=params, with_alignment=True, device=device)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_guided_repeat: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", 0)
    y = torch.rand((1, 3, 32, 32, 1), generator=torch.Generator().manual_seed(2))
    kw = dict(timesteps=3, use_alignment=True, avg_x_gt=[[0.4]])
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        p = predictor(device)

        def forecast():
            return p.predict(y, generator=torch.Generator(device).manual_seed(5), **kw)

        with p.ld._plain_chain():
            eager = [forecast(), forecast()]
        graph = [forecast(), forecast()]
        z = torch.randn((1,) + p.ld.latent_shape, device=device)
        t, avg = torch.tensor([1], device=device), torch.tensor([[0.4]], device=device)
        shifts = [p.ld.alignment.get_mean_shift(z, t, avg) for _ in range(2)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p.ld.alignment.get_mean_shift(z, t, avg)
            torch.cuda.synchronize()
        dgrad = sorted({e.key[:80] for e in prof.key_averages() if "dgrad" in e.key})
        print(json.dumps({
            "cudnn_deterministic": deterministic,
            "eager_equals_eager": torch.equal(eager[0], eager[1]),
            "graph_equals_eager": torch.equal(graph[0], eager[0]),
            "graph_equals_graph": torch.equal(graph[0], graph[1]),
            "shift_equals_shift": torch.equal(shifts[0], shifts[1]),
            "eager_max_abs_diff": float((eager[0] - eager[1]).abs().max()),
            "dgrad_kernels": dgrad}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
