"""DDP training of a UNet with global vectors: two gloo ranks of
``tests/torch_parallel_worker.py`` (task ``variants``, JAX blocked in them),
each its rows of a global batch of 4 at the recipe's rates 0.1, against one
process on the whole batch (CPU).  The masks every site draws, the global
vectors' attention and projection sites and the global FFNs' among them, are
each rank's rows of one process's; the gradients reduced over the ranks are
one process's up to the rounding of a batch of 2 against 4; the ranks end the
step bit-equal."""
import json
import os

import numpy as np
import pytest
import torch
from torch_parallel_worker import run_ranks

from prediff_torch.config import load_config, prediff_default_config
from prediff_torch.factory import build_unet, build_vae
from prediff_torch.models.init import init_params_

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")
B = 4
# the reduced gradient of two ranks at a batch of 2 against one process at 4: the CPU
# products round otherwise (tests/test_torch_ddp_training.py measured 1.1e-6 rel-L2)
GRAD_REL_L2 = 1e-5
VARIANT = dict(num_global_vectors=2, use_global_self_attn=True, separate_global_qkv=True,
               use_global_vector_ffn=True, pos_embed_type="t+hw", ffn_activation="leaky",
               attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1, time_embed_dropout=0.1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("variants_ddp")
    rs = np.random.RandomState(23)
    inputs = {"mask_x": rs.randn(B, 2, 4, 4, 8), "mask_t": np.array([1, 3, 5, 7]),
              "mask_cond": rs.randn(B, 3, 4, 4, 8),
              "train_x": rs.rand(B, 2, 32, 32, 1), "train_y": rs.rand(B, 3, 32, 32, 1)}
    np.savez(out / "inputs.npz", **{k: np.asarray(v, np.float32) for k, v in inputs.items()})
    cfg = load_config(prediff_default_config, TINY)
    cfg.model.latent_model.update(VARIANT)
    gen = torch.Generator().manual_seed(4)
    torch.save({"unet": init_params_(build_unet(cfg), gen, randomize=True).state_dict(),
                "vae": init_params_(build_vae(cfg), gen, randomize=True).state_dict()},
               out / "weights.pt")
    with open(out / "spec.json", "w") as f:
        json.dump({"latent_model": VARIANT}, f)
    run_ranks("variants", str(out))
    return [dict(np.load(out / f"variants{r}.npz")) for r in range(2)]


def _masks(res, name):
    return [res[k] for k in sorted((k for k in res if k.startswith(f"mask_{name}_")),
                                   key=lambda k: int(k.rsplit("_", 1)[1]))]


def test_masks_are_each_ranks_rows_of_one_process(ranks):
    for r, res in enumerate(ranks):
        one, mine = _masks(res, "one"), _masks(res, "mine")
        # first_proj, then per stage and direction: the time block and 3 x (an attention
        # layer's two masks, its global vectors' two, the FFN's two, the global FFN's two)
        assert len(one) == len(mine) == 1 + 4 * (1 + 3 * 8)
        for m_one, m_mine in zip(one, mine):
            assert np.array_equal(m_mine.reshape(2, -1), m_one.reshape(B, -1)[2 * r:2 * r + 2])


def test_ddp_step_is_the_one_process_step(ranks):
    r0, r1 = ranks
    assert np.array_equal(r0["grads_ddp"], r1["grads_ddp"])
    assert str(r0["state_ddp"]) == str(r1["state_ddp"])          # the ranks end bit-equal
    a, b = r0["grads_ddp"].astype(np.float64), r0["grads_one"].astype(np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= GRAD_REL_L2
    assert np.abs(r0["params_ddp"] - r0["params_one"]).max() <= 2 * 1e-3   # within a step's lr
