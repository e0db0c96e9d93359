"""Seeded standalone initialisation for runs without pretrained weights.

``init_params_`` follows the v1 init modes of the JAX package: Linear and
Conv weights N(0, 1/fan_in), biases 0, norm scales 1, embeddings and
relative-position tables truncated N(0, 0.02), the attention pool's
position embedding N(0, 1/embed_dim), and zeros for the layers v1
zero-fills (``ffn_2``, the attention ``proj``, ``out_layers.3``,
``final_proj``).  ``randomize=True`` fills every parameter, those zero-filled
ones and all biases and norm affines too, so that comparisons between two
implementations exercise every weight.
"""
import math

import torch
from torch import nn

ZERO_INIT_SUFFIXES = ("ffn_2.weight", ".proj.weight", "out_layers.3.weight", "final_proj.weight")


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator, randomize: bool = False) -> nn.Module:
    """Fill every parameter of ``module`` in place from ``generator`` (a CPU
    generator: the same seed gives the same weights on every device)."""
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}"
            if isinstance(mod, nn.Embedding) or pname == "relative_position_bias_table":
                vals = torch.randn(p.shape, generator=generator).clamp_(-2.0, 2.0) * 0.02
            elif pname == "positional_embedding":   # attention pool: N(0, 1/embed_dim)
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[0])
            elif pname == "bias":
                vals = (torch.randn(p.shape, generator=generator) * 0.02 if randomize
                        else torch.zeros(p.shape))
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                vals = (1.0 + 0.1 * torch.randn(p.shape, generator=generator) if randomize
                        else torch.ones(p.shape))
            elif not randomize and name.endswith(ZERO_INIT_SUFFIXES):
                vals = torch.zeros(p.shape)
            else:
                fan_in = math.prod(p.shape[1:])
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(vals.to(p.device, p.dtype))
    return module
