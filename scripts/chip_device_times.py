"""Device time (CUDA-graph replay, the host's share out) of the round-1 cuboid
layer (PERF.md row 11b) at (1, 52, 64, 256) with its launches and its f32
library sequence, and of the GroupNorm+SiLU all-gradients backward (row 14) at
the B=1 shapes, on one CUDA card.  It measures the port in the current
directory, so it can time an older tree too: run it from that tree's root,

    python3 /path/to/repo/scripts/chip_device_times.py TAG

where the tree holds a ``chip_smoke.py`` with ``graph_time_ms``,
``launch_split`` and ``v3_library_seq``.  Prints one JSON line tagged TAG.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from prediff_torch.ops.attention import fused_cuboid_attention_layer_v3  # noqa: E402
from prediff_torch.ops.groupnorm import fused_groupnorm_silu_bwd_full  # noqa: E402
from prediff_torch.utils.device import set_numerics  # noqa: E402


def main() -> None:
    set_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*s, scale=1.0):
        return torch.randn(s, generator=gen, device=dev) * scale

    B, nC, vol, C, heads = 1, 52, 64, 256, 4
    args = (randn(B, nC, vol, C), 1 + randn(C, scale=0.1), randn(C, scale=0.1),
            randn(3 * C, C, scale=C ** -0.5), randn(heads, vol, vol, scale=0.5),
            randn(C, C, scale=C ** -0.5), randn(C, scale=0.1), heads, (C // heads) ** -0.5)
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else "."}
    layer = lambda: fused_cuboid_attention_layer_v3(*args)  # noqa: E731
    out["v3_device_ms"] = cs.graph_time_ms(layer)
    out["v3_ms"] = cs.time_ms(layer)
    out["v3_split"] = cs.launch_split(layer)[1]
    out["v3_library_seq_device_ms"] = cs.graph_time_ms(cs.v3_library_seq(*args))
    for B, N, C, G in [(1, 1536, 64, 32), (1, 1536, 128, 32), (1, 3328, 256, 32),
                       (1, 832, 512, 32), (1, 3328, 65, 65)]:
        x, g = randn(B, N, C, scale=2.0) + 1.0, randn(B, N, C)
        w, b = 1 + randn(C, scale=0.1), randn(C, scale=0.1)
        out[f"gn_bwd_{B}_{N}_{C}_{G}_device_ms"] = cs.graph_time_ms(
            lambda: fused_groupnorm_silu_bwd_full(x, g, w, b, None, G))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
