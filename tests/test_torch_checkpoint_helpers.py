"""The readers of the reference's training checkpoints: the port's
``utils/convert.extract_ema_state_dict`` and ``strip_prefix`` and the
``prefix=`` / ``strict=`` of ``utils/checkpoint.load_torch_state_dict``, on
the synthetic Lightning dicts of ``tests/test_convert.py`` rebuilt here, and
against the JAX package's functions on the same dicts.  No weights are
downloaded."""
import numpy as np
import pytest
import torch

from prediff_tpu.utils.convert import extract_ema_state_dict as jax_extract_ema_state_dict
from prediff_tpu.utils.convert import strip_prefix as jax_strip_prefix
from prediff_torch.utils.checkpoint import load_torch_state_dict
from prediff_torch.utils.convert import extract_ema_state_dict, strip_prefix


def _pl_dict():
    """A Lightning PreDiff checkpoint's state_dict: the model under
    ``torch_nn_module.``, LitEma's shadows under dot-stripped names, its
    counters, and a key of neither."""
    return {
        "torch_nn_module.blocks.0.attn.qkv.weight": np.zeros(2),
        "torch_nn_module.final_proj.bias": np.zeros(2),
        "model_ema.blocks0attnqkvweight": np.ones(2),
        "model_ema.final_projbias": np.full(2, 3.0),
        "model_ema.decay": np.asarray(0.9999),
        "model_ema.num_updates": np.asarray(5),
        "logvar": np.zeros(3),
    }


def test_extract_ema_state_dict():
    pl_sd = _pl_dict()
    ema = extract_ema_state_dict(pl_sd)
    assert set(ema) == {"blocks.0.attn.qkv.weight", "final_proj.bias"}
    np.testing.assert_array_equal(ema["blocks.0.attn.qkv.weight"], np.ones(2))
    np.testing.assert_array_equal(ema["final_proj.bias"], np.full(2, 3.0))
    want = jax_extract_ema_state_dict(pl_sd)
    assert set(want) == set(ema)
    for k in want:
        np.testing.assert_array_equal(ema[k], want[k])


def test_extract_ema_state_dict_refuses_an_ambiguous_name():
    pl_sd = {"torch_nn_module.a.bc": np.zeros(1), "torch_nn_module.ab.c": np.zeros(1),
             "model_ema.abc": np.ones(1)}
    with pytest.raises(ValueError, match="ambiguous"):
        extract_ema_state_dict(pl_sd)


def test_strip_prefix_matches_jax():
    pl_sd = _pl_dict()
    got = strip_prefix(pl_sd, "torch_nn_module.")
    assert got == jax_strip_prefix(pl_sd, "torch_nn_module.")
    assert set(got) == {"blocks.0.attn.qkv.weight", "final_proj.bias"}


class _Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(2, 3)
        self.norm = torch.nn.BatchNorm1d(3)


def _lightning_file(path, net, extra=None):
    sd = {f"torch_nn_module.{k}": v + 1.0 if v.is_floating_point() else v
          for k, v in net.state_dict().items()}
    sd.update({"model_ema.projweight": torch.zeros(3, 2), "model_ema.decay": torch.tensor(0.9)})
    sd.update(extra or {})
    torch.save({"state_dict": sd, "epoch": 3}, path)
    return sd


def test_load_torch_state_dict_with_a_prefix(tmp_path):
    net = _Net()
    sd = _lightning_file(tmp_path / "ckpt.pt", net)
    got = load_torch_state_dict(str(tmp_path / "ckpt.pt"), net, prefix="torch_nn_module.")
    assert set(got) == set(net.state_dict())
    loaded = _Net()
    loaded.load_state_dict(got)
    assert torch.equal(loaded.proj.weight, sd["torch_nn_module.proj.weight"])


def test_load_torch_state_dict_strict_and_not(tmp_path):
    net = _Net()
    _lightning_file(tmp_path / "ckpt.pt", net, {"torch_nn_module.head.weight": torch.zeros(1)})
    got = load_torch_state_dict(str(tmp_path / "ckpt.pt"), net, prefix="torch_nn_module.")
    assert "head.weight" in got                       # strict: load_state_dict refuses it
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _Net().load_state_dict(got)
    got = load_torch_state_dict(str(tmp_path / "ckpt.pt"), net, prefix="torch_nn_module.",
                                strict=False)
    assert set(got) == set(net.state_dict())          # only the model's keys
    _Net().load_state_dict(got, strict=False)
    # without the prefix nothing of the model is matched: every key missing
    got = load_torch_state_dict(str(tmp_path / "ckpt.pt"), net, strict=False)
    assert got == {}
    with pytest.raises(RuntimeError, match="Missing key"):
        _Net().load_state_dict(load_torch_state_dict(str(tmp_path / "ckpt.pt"), net))


def test_ema_weights_of_a_lightning_file_load_into_the_model(tmp_path):
    net = _Net()
    _lightning_file(tmp_path / "ckpt.pt", net)
    ckpt = torch.load(tmp_path / "ckpt.pt", weights_only=True)["state_dict"]
    ema = extract_ema_state_dict(ckpt)
    assert set(ema) == {"proj.weight"}
    loaded = _Net()
    loaded.load_state_dict(ema, strict=False)
    assert torch.equal(loaded.proj.weight, torch.zeros(3, 2))
