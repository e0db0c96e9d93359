"""The port's profiling helpers (``prediff_torch/utils/profiling.py``) against
the JAX package's (``prediff_tpu/utils/profiling.py``) on the CPU:
``StepTimer.summary`` on the same injected times, ``tree_grad_norms`` on the
same numpy leaves, a ``trace`` file that holds an ``annotate`` range, and
``count_kernel_launches`` against ``count_pallas_calls`` (``make_jaxpr``
only) on a depth-[1,1] UNet whose every layer takes a kernel in both
packages."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prediff_tpu.config import load_config as jax_load_config
from prediff_tpu.config import prediff_default_config as jax_default_config
from prediff_tpu.factory import build_unet as jax_build_unet
from prediff_tpu.utils import profiling as jprof
from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet
from prediff_torch.ops import _build
from prediff_torch.utils import profiling as tprof

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
# widths and token counts that every kernel of both packages takes: base units
# 128 and 256, 128 and 32 tokens a stage (the JAX FFN's tiles are multiples of 8)
KERNEL_UNET = dict(base_units=128, depth=[1, 1], input_shape=[4, 4, 4, 8],
                   target_shape=[4, 4, 4, 8], self_pattern="axial", use_pallas_attention=True,
                   use_pallas_ffn=True, use_pallas_gn=True, use_pallas_resblock=True)


def test_step_timer_summary_equals_jax():
    times = list(np.random.RandomState(0).uniform(0.01, 0.2, size=9))
    jt, tt = jprof.StepTimer(), tprof.StepTimer()
    assert jt.summary() == tt.summary() == {}
    jt.times, tt.times = list(times), list(times)
    want, got = jt.summary(), tt.summary()
    assert set(got) == set(want) == {"mean_s", "p50_s", "p90_s", "max_s", "steps_per_sec", "n"}
    assert got == want
    with tt:
        pass
    assert tt.summary()["n"] == 10 and tt.times[-1] >= 0.0
    assert tprof.StepTimer(device="cpu").device == torch.device("cpu")


def test_tree_grad_norms_equal_jax():
    rs = np.random.RandomState(1)
    tree = {"unet": {"first_proj": {"kernel": rs.randn(3, 3, 3, 9, 16).astype(np.float32),
                                    "bias": rs.randn(16).astype(np.float32)},
                     "final_proj": {"kernel": 1e-3 * rs.randn(16, 8).astype(np.float32)}},
            "logvar": rs.randn(8).astype(np.float32)}
    want = jprof.tree_grad_norms(jax.tree_util.tree_map(jnp.asarray, tree))
    got = tprof.tree_grad_norms(jax.tree_util.tree_map(torch.from_numpy, tree))
    assert sorted(got) == sorted(want) == ["logvar", "unet/final_proj/kernel",
                                           "unet/first_proj/bias", "unet/first_proj/kernel"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    flat = {"unet.first_proj.weight": torch.from_numpy(tree["logvar"])}
    assert list(tprof.tree_grad_norms(flat)) == ["unet.first_proj.weight"]
    assert tprof.tree_grad_norms({}) == {}


def test_trace_writes_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        with tprof.annotate("prediff_probe_range"):
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "prediff_probe_range" for e in events)
    assert any(e.key == "prediff_probe_range" for e in prof.key_averages())


def test_count_kernel_launches_of_library_code_is_empty():
    x = torch.randn(8, 8)
    assert tprof.count_kernel_launches(lambda v: torch.tanh(v) @ v.T, x) == {}
    assert _build.SCOPES == []


def test_every_wrapper_has_its_tpu_kernel():
    """Every wrapper that dispatches at ``_build.on_card`` is in the table,
    and each TPU name is a ``pl.pallas_call`` name of the JAX package."""
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    wrappers, names = set(), set()
    for src in glob.glob(os.path.join(root, "prediff_torch", "ops", "*.py")):
        wrappers |= set(re.findall(r"_build\.on_card\((\w+),", open(src).read()))
    for src in glob.glob(os.path.join(root, "prediff_tpu", "ops", "pallas_*.py")):
        names |= set(re.findall(r'name="(\w+)"', open(src).read()))
    assert wrappers == set(tprof.TPU_KERNELS)
    assert set(tprof.TPU_KERNELS.values()) <= names


def test_count_kernel_launches_equals_count_pallas_calls():
    """A depth-[1,1] UNet forward, kernel by kernel.  The one difference is
    the time blocks: the JAX package fuses each into one ``fused_resblock``
    call, while the port runs them unfused (ROADMAP.md section 4), two
    GroupNorm + SiLU calls each."""
    jcfg = jax_load_config(jax_default_config, TINY)
    jcfg.model.latent_model.update(KERNEL_UNET)
    tcfg = load_config(prediff_default_config, TINY)
    tcfg.model.latent_model.update(KERNEL_UNET)
    L = tcfg.model.latent_model
    rs = np.random.RandomState(2)
    x = rs.randn(1, *L.target_shape).astype(np.float32)
    cond = rs.randn(1, *L.input_shape).astype(np.float32)
    t = np.array([7], np.int32)

    junet = jax_build_unet(jcfg)
    jx, jc, jt = jnp.asarray(x), jnp.asarray(cond), jnp.asarray(t)
    params = jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(0), jx, jt, jc))
    want = jprof.count_pallas_calls(lambda p: junet.apply(p, jx, jt, jc), params)

    unet = build_unet(tcfg).eval()
    with torch.no_grad():
        got = tprof.count_kernel_launches(unet, torch.from_numpy(x), torch.from_numpy(t).long(),
                                          torch.from_numpy(cond))
    time_blocks = 2 * sum(L.depth)
    assert want["fused_resblock"] == time_blocks
    assert "fused_resblock" not in got
    assert got["fused_groupnorm_silu"] == want["fused_groupnorm_silu"] + 2 * time_blocks
    rest = {k: v for k, v in want.items() if k not in ("fused_resblock", "fused_groupnorm_silu")}
    assert rest == {"fused_cuboid_attention_grouped": 12, "fused_ffn": 12}
    assert {k: v for k, v in got.items() if k != "fused_groupnorm_silu"} == rest


@pytest.mark.parametrize("remat", [False, True])
def test_count_kernel_launches_of_a_training_micro_step(remat):
    """The dynamic count of a micro-step at rates 0.1: under ``remat_unet``
    every forward call of a recomputed block pair runs twice (the time
    blocks' GroupNorms and the FFNs; ``first_proj`` is outside every pair),
    the backwards once."""
    from prediff_torch.datasets.synthetic import synthetic_batch_iterator
    from prediff_torch.factory import build_training_pipeline
    from prediff_torch.training import DiffusionTrainer

    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(KERNEL_UNET, attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1,
                                  time_embed_dropout=0.1)
    cfg.model.latent_model.update(input_shape=[3, 4, 4, 8], target_shape=[2, 4, 4, 8])
    ld = build_training_pipeline(cfg, device="cpu", seed=1)
    trainer = DiffusionTrainer(ld, optim_config=dict(lr=1e-3, total_num_steps=8),
                               remat_unet=remat)
    state = trainer.create_state()
    L = cfg.layout
    b = torch.from_numpy(next(synthetic_batch_iterator(2, L.in_len + L.out_len, L.img_height,
                                                       L.img_width, seed=0)))
    got = tprof.count_kernel_launches(trainer.grads, state, 3, b[:, L.in_len:],
                                      b[:, :L.in_len])
    time_gn = 2 * 2 * sum(cfg.model.latent_model.depth)   # down and up, two a time block
    again = 2 if remat else 1
    assert got == {"fused_groupnorm_silu": 2 + again * time_gn, "fused_ffn_dropout": 12 * again,
                   "fused_groupnorm_silu_bwd_full": 2 + time_gn,
                   "fused_ffn_dropout_bwd_full": 12}
