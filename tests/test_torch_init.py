"""The port's factories and seeded initialisation against the JAX package's
(CPU, configs/tiny_smoke.yaml).

The knobs that the JAX models assert to one value (``downsample_type``,
``upsample_type``) raise ``NotImplementedError`` naming them at build time;
every other variant of the model knobs builds, as the JAX factory builds it,
and changes the built model (its parameters, layouts or init modes) where the
JAX model reads the knob.

``init_params_`` (the v1 init, ``randomize=False``) against the JAX package's
init of the same configuration, leaf by leaf: a constant leaf (zeros, ones)
equal; on each leaf of 1000 or more elements the std within 10%, a loose
statistical bar (the sampling error of the std of n independent draws is
about 1/sqrt(2n), at most 2.2% here), and the range: a bounded draw (uniform,
truncated normal: max |w| under 2.6 std) reaches its bound within 10% on both
sides, an unbounded one (normal) passes 2.6 std on both sides.
"""
import os

import pytest
import torch

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_alignment_model as jax_build_alignment_model
from prediff_tpu.factory import build_pipeline as jax_build_pipeline
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import (ALIGN_ASSERTED, UNET_ASSERTED, build_alignment_model,
                                   build_unet, build_vae)
from prediff_torch.models.init import init_params_
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
STD_TOL = 0.1
BOUNDED = 2.6      # max |w| / std below this: a bounded draw (uniform 1.73, truncated 2.27)

# a value other than v1's for each knob
OTHER = {"pos_embed_type": "t+hw", "use_relative_pos": False, "self_attn_use_final_proj": False,
         "downsample_type": "conv", "upsample_type": "conv"}
_INIT_KEYS = ("attn_linear_init_mode", "ffn_linear_init_mode", "ffn2_linear_init_mode",
              "attn_proj_linear_init_mode", "conv_init_mode", "global_proj_linear_init_mode",
              "norm_init_mode")
_COMMON = ("pos_embed_type", "use_relative_pos", "self_attn_use_final_proj", "downsample_type")
UNET_KNOBS = [(k, OTHER.get(k, "1")) for k in _COMMON + _INIT_KEYS
              + ("upsample_type", "down_up_linear_init_mode")]
ALIGN_KNOBS = [(k, OTHER.get(k, "1")) for k in _COMMON + _INIT_KEYS + ("down_linear_init_mode",)]
# knobs that change nothing in the built model: read by no layer of the JAX
# model (norm_init_mode in both, conv_init_mode in the alignment net: it has no
# upsample), or whose new leaves the v1 configuration does not reach
# (global_proj_linear_init_mode: no global vectors there)
UNCHANGED = {"norm_init_mode", "global_proj_linear_init_mode"}


def _signature(model):
    """What a knob can change in a built model: its state_dict's keys and
    shapes, the init modes its layers carry, its position embeddings' kinds."""
    return (sorted((k, tuple(v.shape)) for k, v in model.state_dict().items()),
            sorted((n, getattr(m, "init_mode", None)) for n, m in model.named_modules()),
            sorted((n, getattr(m, "typ", None)) for n, m in model.named_modules()))


def _knob_builds_or_refuses(cfg, section, build, asserted, key, value, unchanged):
    default = _signature(build(cfg))
    section[key] = value
    if key in asserted:
        with pytest.raises(NotImplementedError, match=key):
            build(cfg)
        return
    built = _signature(build(cfg))
    assert (built == default) == (key in unchanged), key


@pytest.mark.parametrize("key,value", UNET_KNOBS, ids=[k for k, _ in UNET_KNOBS])
def test_unet_refuses_a_knob_it_does_not_build(key, value):
    cfg = load_config(prediff_default_config, TINY)
    _knob_builds_or_refuses(cfg, cfg.model.latent_model, build_unet, UNET_ASSERTED, key, value,
                            UNCHANGED)
    jcfg = jax_load_config(jax_default_config)
    jcfg.model.latent_model[key] = value
    assert jax_build_unet(jcfg) is not None


@pytest.mark.parametrize("key,value", ALIGN_KNOBS, ids=[k for k, _ in ALIGN_KNOBS])
def test_alignment_net_refuses_a_knob_it_does_not_build(key, value):
    cfg = load_config(prediff_default_config, TINY)
    _knob_builds_or_refuses(cfg, cfg.model.align.model_args, build_alignment_model,
                            ALIGN_ASSERTED, key, value, UNCHANGED | {"conv_init_mode"})
    jcfg = jax_load_config(jax_default_config)
    jcfg.model.align.model_args[key] = value
    assert jax_build_alignment_model(jcfg) is not None


@pytest.fixture(scope="module")
def jax_init():
    _, params = jax_build_pipeline(jax_load_config(jax_default_config, TINY), with_alignment=True)
    return params


@pytest.mark.parametrize("which,build", [("unet", build_unet), ("align", build_alignment_model),
                                         ("vae", build_vae)])
def test_v1_initialisation_matches_the_jax_init(jax_init, which, build):
    model = build(load_config(prediff_default_config, TINY))
    want = flax_params_to_torch(model, jax_init[which])
    got = init_params_(model, torch.Generator().manual_seed(0)).state_dict()
    compared = 0
    for name, w in want.items():
        a, b = got[name].double(), w.double()
        if float(b.std() if b.numel() > 1 else 0.0) == 0.0:
            assert torch.equal(a, b), name           # zeros, ones
            continue
        if b.numel() < 1000:
            continue
        std_a, std_b = float(a.std()), float(b.std())
        assert abs(std_a / std_b - 1.0) <= STD_TOL, (name, std_a, std_b)
        max_a, max_b = float(a.abs().max()), float(b.abs().max())
        if max_b / std_b < BOUNDED:
            assert abs(max_a / max_b - 1.0) <= STD_TOL, (name, max_a, max_b)
        else:
            assert max_a / std_a >= BOUNDED, (name, max_a / std_a)
        compared += 1
    assert compared >= 5, compared
