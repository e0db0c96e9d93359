"""The port's factories and seeded initialisation against the JAX package's
(CPU, configs/tiny_smoke.yaml).

Every configuration knob the port does not build raises
``NotImplementedError`` naming it, where the JAX factory builds the model.

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
from prediff_torch.factory import (ALIGN_PORTED, UNET_PORTED, build_alignment_model, build_unet,
                                   build_vae)
from prediff_torch.models.init import init_params_
from prediff_torch.utils.convert import flax_params_to_torch

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
STD_TOL = 0.1
BOUNDED = 2.6      # max |w| / std below this: a bounded draw (uniform 1.73, truncated 2.27)

# a value the JAX package builds and the port does not, for each knob
OTHER = {"pos_embed_type": "t+hw", "use_relative_pos": False, "self_attn_use_final_proj": False,
         "downsample_type": "conv", "upsample_type": "conv"}
UNET_KNOBS = [(k, OTHER.get(k, "1")) for k in UNET_PORTED]
ALIGN_KNOBS = [(k, OTHER.get(k, "1")) for k in ALIGN_PORTED]


@pytest.mark.parametrize("key,value", UNET_KNOBS, ids=[k for k, _ in UNET_KNOBS])
def test_unet_refuses_a_knob_it_does_not_build(key, value):
    cfg = load_config(prediff_default_config)
    build_unet(load_config(prediff_default_config, TINY))      # the defaults build
    cfg.model.latent_model[key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_unet(cfg)
    jcfg = jax_load_config(jax_default_config)
    jcfg.model.latent_model[key] = value
    assert jax_build_unet(jcfg) is not None


@pytest.mark.parametrize("key,value", ALIGN_KNOBS, ids=[k for k, _ in ALIGN_KNOBS])
def test_alignment_net_refuses_a_knob_it_does_not_build(key, value):
    cfg = load_config(prediff_default_config)
    cfg.model.align.model_args[key] = value
    with pytest.raises(NotImplementedError, match=key):
        build_alignment_model(cfg)
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
