"""The shared bf16 weight cache of ``ops/weights.py`` for ``Linear`` weights
(what the FFN and axial attention forwards read by TMA), on the CPU: a new
layout after every in-place update the port makes (its optimizer step, fused
and foreach; the EMA's ``torch._foreach_lerp_``; ``TrainState.load_state_dict``'s
``copy_``), a layout of its own for each EMA tensor handed to
``torch.func.functional_call``, nothing of it in ``torch.save``, and the
entry gone with its parameter.  (An update through ``weight.data`` bypasses
PyTorch's version counter and is not seen; ``PERF.md`` notes the gap.)"""
import gc
import io
import weakref

import pytest
import torch
from torch import nn

from prediff_torch.ops import weights
from prediff_torch.training.ema import ema_update
from prediff_torch.training.optim import Optimizer, build_optimizer
from prediff_torch.training.train_state import EmaTrainState


def _is_copy_of(layout, w):
    return (layout.dtype == torch.bfloat16 and layout.is_contiguous()
            and torch.equal(layout, w.detach().to(torch.bfloat16)))


def test_layout_is_the_weight_in_bf16_once_per_version():
    lin = nn.Linear(128, 384)
    first = weights.linear_bf16(lin.weight)
    assert first.shape == (384, 128) and _is_copy_of(first, lin.weight)
    assert weights.linear_bf16(lin.weight) is first
    with torch.no_grad():
        lin.weight.mul_(2.0)
    second = weights.linear_bf16(lin.weight)
    assert second is not first and _is_copy_of(second, lin.weight)


def _step(lin, tx):
    lin(torch.randn(4, lin.in_features)).square().mean().backward()
    grads = [p.grad.clone() for p in lin.parameters()]
    for p in lin.parameters():
        p.grad = None
    assert tx.update(grads)


@pytest.mark.parametrize("impl", ["port", "fused", "foreach"])
def test_layout_follows_the_optimizer_step(impl):
    torch.manual_seed(0)
    lin = nn.Linear(64, 128)
    params = list(lin.parameters())
    if impl == "port":
        tx = build_optimizer(params, lr=1e-2, total_num_steps=10)
    else:
        opt = torch.optim.AdamW(params, lr=1e-2, **{impl: True})
        tx = Optimizer(params, opt, lambda count: 1e-2, 1.0, 1)
    first = weights.linear_bf16(lin.weight)
    _step(lin, tx)
    second = weights.linear_bf16(lin.weight)
    assert second is not first and _is_copy_of(second, lin.weight)
    assert not torch.equal(second, first)


def test_layout_follows_the_ema_update():
    lin = nn.Linear(64, 128)
    shadow = lin.weight.detach().clone()
    first = weights.linear_bf16(shadow)
    with torch.no_grad():
        lin.weight.add_(1.0)
    ema_update([shadow], [lin.weight], decay=0.5, num_updates=-1)
    second = weights.linear_bf16(shadow)
    assert second is not first and _is_copy_of(second, shadow)


def test_layout_follows_load_state_dict():
    lin = nn.Linear(64, 128)
    params = dict(lin.named_parameters())
    tx = build_optimizer(list(params.values()), lr=1e-2, total_num_steps=10)
    state = EmaTrainState.create(params, tx)
    saved = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in state.state_dict().items()}
    saved["params"] = {k: v + 1.0 for k, v in saved["params"].items()}
    saved["ema_params"] = {k: v - 1.0 for k, v in state.ema_params.items()}
    first = weights.linear_bf16(lin.weight)
    ema_first = weights.linear_bf16(state.ema_params["weight"])
    state.load_state_dict(saved)
    second = weights.linear_bf16(lin.weight)
    assert second is not first and _is_copy_of(second, lin.weight)
    ema_second = weights.linear_bf16(state.ema_params["weight"])
    assert ema_second is not ema_first and _is_copy_of(ema_second, state.ema_params["weight"])


class _ReadsTheCache(nn.Module):
    """A module whose forward reads its weight through the cache, as the
    kernel wrappers do."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(64, 32)

    def forward(self, x):
        return x @ weights.linear_bf16(self.lin.weight).float().T


def test_functional_call_tensors_are_laid_out_apart():
    mod = _ReadsTheCache()
    ema = {k: v.detach().clone() - 0.5 for k, v in mod.named_parameters()}
    x = torch.randn(3, 64)
    live = mod(x)
    shadowed = torch.func.functional_call(mod, ema, (x,))
    assert torch.equal(shadowed, x @ ema["lin.weight"].to(torch.bfloat16).float().T)
    assert not torch.equal(shadowed, live)
    assert torch.equal(mod(x), live)   # the live parameter's layout is untouched
    assert weights.linear_bf16(ema["lin.weight"]) is not weights.linear_bf16(mod.lin.weight)


def test_save_carries_no_cache():
    lin = nn.Linear(128, 256)

    def saved():
        buf = io.BytesIO()
        torch.save({"w": lin.weight, "sd": lin.state_dict()}, buf)
        return buf

    before = saved().getbuffer().nbytes
    weights.linear_bf16(lin.weight)
    buf = saved()
    assert buf.getbuffer().nbytes == before
    buf.seek(0)
    assert torch.equal(torch.load(buf)["w"], lin.weight)


def test_entry_goes_with_its_parameter():
    lin = nn.Linear(128, 256)
    slot = (id(lin.weight), "linear")
    ref = weakref.ref(weights.linear_bf16(lin.weight))
    assert slot in weights._LAYOUTS and ref() is not None
    del lin
    gc.collect()
    assert ref() is None and slot not in weights._LAYOUTS


# ---- the transposed kind: the backwards' W^T operands ----
def _is_transposed_copy_of(layout, w):
    return (layout.dtype == torch.bfloat16 and layout.is_contiguous()
            and torch.equal(layout, w.detach().t().to(torch.bfloat16)))


def test_transposed_layout_is_kept_once_per_version_beside_the_other():
    lin = nn.Linear(128, 384)
    t1 = weights.linear_t_bf16(lin.weight)
    assert t1.shape == (128, 384) and _is_transposed_copy_of(t1, lin.weight)
    assert weights.linear_t_bf16(lin.weight) is t1
    plain = weights.linear_bf16(lin.weight)
    assert weights.linear_t_bf16(lin.weight) is t1 and weights.linear_bf16(lin.weight) is plain
    with torch.no_grad():
        lin.weight.mul_(2.0)
    t2 = weights.linear_t_bf16(lin.weight)
    assert t2 is not t1 and _is_transposed_copy_of(t2, lin.weight)


@pytest.mark.parametrize("impl", ["port", "fused"])
def test_transposed_layout_follows_the_optimizer_step(impl):
    torch.manual_seed(1)
    lin = nn.Linear(64, 128)
    params = list(lin.parameters())
    if impl == "port":
        tx = build_optimizer(params, lr=1e-2, total_num_steps=10)
    else:
        opt = torch.optim.AdamW(params, lr=1e-2, fused=True)
        tx = Optimizer(params, opt, lambda count: 1e-2, 1.0, 1)
    first = weights.linear_t_bf16(lin.weight)
    _step(lin, tx)
    second = weights.linear_t_bf16(lin.weight)
    assert second is not first and _is_transposed_copy_of(second, lin.weight)
    assert not torch.equal(second, first)


def test_transposed_entry_goes_with_its_parameter():
    lin = nn.Linear(128, 256)
    slot = (id(lin.weight), "linear_t")
    ref = weakref.ref(weights.linear_t_bf16(lin.weight))
    assert slot in weights._LAYOUTS and ref() is not None
    del lin
    gc.collect()
    assert ref() is None and slot not in weights._LAYOUTS
