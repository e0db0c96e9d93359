"""Seeded standalone initialisation for runs without pretrained weights.

``init_params_`` follows the v1 init modes of the JAX package
(``prediff_tpu/models/init.py``): Linear weights N(0, 1/fan_in) (linear mode
"0"), convolution kernels U(+-sqrt(1/fan_in)) (conv mode "0", the torch
default), biases 0, norm scales 1, embeddings and relative-position tables a
normal of std 0.02 truncated at 2 std (resampled, as
``jax.nn.initializers.truncated_normal``), the attention pool's position
embedding N(0, 1/embed_dim), and zeros for the layers v1 zero-fills
(``ffn_2``, the attention ``proj``, ``out_layers.3``, ``final_proj``).  A
module whose class sets ``FLAX_DEFAULT_INIT`` (the VAE, the attention pool)
takes flax's default instead for every conv and Linear weight inside it:
``lecun_normal``, a normal truncated at 2 std and rescaled to variance
1/fan_in.  ``randomize=True`` fills every parameter, those zero-filled ones
and all biases and norm affines too, so that comparisons between two
implementations exercise every weight.

A Linear or convolution whose init mode the configuration sets
(``attn_linear_init_mode`` and the other ``*_init_mode`` keys) carries it as
``init_mode`` (:func:`with_init`), and takes the JAX package's mode
(``prediff_tpu/models/init.py``): linear "0" N(0, 1/fan_in), "1" N(0,
2 / (1.01 fan_out)) (kaiming-normal, fan_out, leaky_relu(0.1)), "2" zeros;
conv "0" U(+-sqrt(1/fan_in)), "1" as linear "1", "2" zeros.  The global
vectors' ``init_global_vectors`` take the embeddings' truncated normal.
"""
import math

import torch
from torch import nn

ZERO_INIT_SUFFIXES = ("ffn_2.weight", ".proj.weight", "out_layers.3.weight", "final_proj.weight")
# the std of a standard normal truncated at +-2 (jax.nn.initializers.variance_scaling)
_TRUNC2_STD = 0.87962566103423978


def with_init(module: nn.Module, mode: str) -> nn.Module:
    """``module`` (a Linear or a convolution) marked with its init mode."""
    if mode not in ("0", "1", "2"):
        raise NotImplementedError(f"init mode {mode!r} (the JAX package's: '0', '1', '2')")
    module.init_mode = mode
    return module


def _trunc_normal(shape, std, generator):
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2.0 * std, b=2.0 * std,
                                 generator=generator)


@torch.no_grad()
def init_params_(module: nn.Module, generator: torch.Generator, randomize: bool = False) -> nn.Module:
    """Fill every parameter of ``module`` in place from ``generator`` (a CPU
    generator: the same seed gives the same weights on every device)."""
    lecun_scopes = [name for name, mod in module.named_modules()
                    if getattr(mod, "FLAX_DEFAULT_INIT", False)]
    for mod_name, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}"
            fan_in = math.prod(p.shape[1:])
            mode = getattr(mod, "init_mode", None) if pname == "weight" else None
            if (isinstance(mod, nn.Embedding)
                    or pname in ("relative_position_bias_table", "init_global_vectors")):
                vals = (torch.randn(p.shape, generator=generator).clamp_(-2.0, 2.0) * 0.02
                        if randomize else _trunc_normal(p.shape, 0.02, generator))
            elif pname == "positional_embedding":   # attention pool: N(0, 1/embed_dim)
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(p.shape[0])
            elif pname == "bias":
                vals = (torch.randn(p.shape, generator=generator) * 0.02 if randomize
                        else torch.zeros(p.shape))
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                vals = (1.0 + 0.1 * torch.randn(p.shape, generator=generator) if randomize
                        else torch.ones(p.shape))
            elif randomize:
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            elif mode == "2":
                vals = torch.zeros(p.shape)
            elif mode == "1":   # fan_out: the output channels times the receptive field
                fan_out = p.shape[0] * math.prod(p.shape[2:])
                vals = torch.randn(p.shape, generator=generator) * math.sqrt(2.0 / 1.01 / fan_out)
            elif mode == "0" and isinstance(mod, nn.Linear):
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            elif name.endswith(ZERO_INIT_SUFFIXES):
                vals = torch.zeros(p.shape)
            elif any(s in ("", mod_name) or mod_name.startswith(s + ".") for s in lecun_scopes):
                vals = _trunc_normal(p.shape, 1.0 / math.sqrt(fan_in) / _TRUNC2_STD, generator)
            elif isinstance(mod, nn.modules.conv._ConvNd):
                bound = 1.0 / math.sqrt(fan_in)
                vals = torch.rand(p.shape, generator=generator) * (2.0 * bound) - bound
            else:
                vals = torch.randn(p.shape, generator=generator) / math.sqrt(fan_in)
            p.copy_(vals.to(p.device, p.dtype))
    return module
