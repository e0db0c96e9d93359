"""``fit(steps_per_call=K)`` with a scan function, as the JAX loop's test
holds it (``tests/test_loop_checkpoint.py``): the step accounting, the
per-step metric records on the logging cadence, equality with the K = 1 loop
on the same batches, the error without a scan function, ``max_steps``
rounded up to a call's boundary; and ``train_sevirlr_prediff`` with
``optim.steps_per_call: 2`` against the same run with 1, and the stacking of
the host batches (``datasets.prefetch.stack_chunks``)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from prediff_torch.cli import train_sevirlr_prediff
from prediff_torch.datasets import make_synthetic_sevir_lr, stack_chunks
from prediff_torch.training import fit

TINY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "tiny_smoke.yaml")


class _Linear:
    """A least-squares model's train state: ``w`` (2, 2), ``b`` (2,), an SGD
    update a step, ``step`` counting them."""

    def __init__(self):
        rs = np.random.RandomState(1)
        self.w = torch.from_numpy(rs.randn(2, 2).astype(np.float32))
        self.b = torch.zeros(2)
        self.step = 0

    def state_dict(self):
        return {"w": self.w, "b": self.b, "step": self.step}


def _single_step(state, seed, x):
    w, b = state.w.clone().requires_grad_(True), state.b.clone().requires_grad_(True)
    loss = (x @ w + b).square().mean()
    gw, gb = torch.autograd.grad(loss, (w, b))
    state.w, state.b = (state.w - 0.1 * gw).detach(), (state.b - 0.1 * gb).detach()
    state.step += 1
    return state, {"train/loss": loss.detach()}


def _scan_step(state, seed, xs):
    got = []
    for x in xs:
        state, m = _single_step(state, seed, x)
        got.append(m)
    return state, {k: torch.stack([m[k] for m in got]) for k in got[0]}


def test_fit_steps_per_call_scan_chunks(tmp_path):
    rs = np.random.RandomState(0)
    flat = [torch.from_numpy(rs.randn(8, 2).astype(np.float32)) for _ in range(8)]

    def batches_k1(epoch):
        yield from flat[epoch * 4:(epoch + 1) * 4]

    def batches_chunked(epoch):
        yield from (torch.from_numpy(c) for c in stack_chunks(flat[epoch * 4:(epoch + 1) * 4], 2))

    d1, d2 = tmp_path / "k1", tmp_path / "k2"
    out1 = fit(_Linear(), _single_step, batches_k1, lambda b: (b,), max_epochs=2,
               save_dir=str(d1), seed=0, log_every_n_steps=3)
    out2 = fit(_Linear(), _single_step, batches_chunked, lambda b: (b,), max_epochs=2,
               save_dir=str(d2), seed=0, log_every_n_steps=3, train_step_scan=_scan_step,
               steps_per_call=2)
    assert out1.step == out2.step == 8
    assert torch.equal(out1.w, out2.w) and torch.equal(out1.b, out2.b)
    recs1 = [json.loads(line) for line in open(d1 / "metrics.jsonl")]
    recs2 = [json.loads(line) for line in open(d2 / "metrics.jsonl")]
    assert [r["step"] for r in recs1] == [r["step"] for r in recs2] == [3, 6]
    assert [r["train/loss"] for r in recs1] == [r["train/loss"] for r in recs2]

    with pytest.raises(ValueError, match="train_step_scan"):
        fit(_Linear(), _single_step, batches_chunked, lambda b: (b,), max_epochs=1,
            save_dir=str(tmp_path / "err"), seed=0, steps_per_call=2)
    out3 = fit(_Linear(), _single_step, batches_chunked, lambda b: (b,), max_epochs=2,
               save_dir=str(tmp_path / "k3"), seed=0, train_step_scan=_scan_step,
               steps_per_call=2, max_steps=3)
    assert out3.step == 4          # max_steps rounds up to the call's boundary


def test_stack_chunks_drops_the_ragged_tail():
    items = [(np.full((2, 3), i), np.full((2,), -i)) for i in range(5)]
    chunks = list(stack_chunks(items, 2))
    assert len(chunks) == 2
    assert chunks[1][0].shape == (2, 2, 3) and chunks[1][1].shape == (2, 2)
    assert chunks[1][0][:, 0, 0].tolist() == [2, 3] and chunks[0][1][:, 0].tolist() == [0, -1]
    assert [c.shape for c in stack_chunks([np.zeros(4)] * 3, 3)] == [(3, 4)]


def test_train_program_steps_per_call(tmp_path):
    """``train_sevirlr_prediff`` on the tiny configuration at the recipe's
    dropout rates with ``optim.steps_per_call: 2``: the same last state, bit
    for bit, as the run with 1 (four micro-steps, two optimizer steps)."""
    sevir = str(tmp_path / "synthetic_sevirlr")
    make_synthetic_sevir_lr(sevir, num_events=8, H=32, W=32, T=25)
    with open(TINY) as f:
        tree = yaml.safe_load(f)
    tree["model"]["latent_model"].update(attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1)
    states = []
    for k in (1, 2):
        tree.setdefault("optim", {})["steps_per_call"] = k
        cfg_path = str(tmp_path / f"k{k}.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(tree, f)
        save = str(tmp_path / f"run{k}")
        assert train_sevirlr_prediff.main(["--save", save, "--cfg", cfg_path, "--sevir-dir",
                                           sevir, "--device", "cpu", "--max-steps", "4"]) == 0
        states.append(torch.load(os.path.join(save, "ckpt_last", "step_4.pt"),
                                 weights_only=True))
    a, b = states
    assert a["step"] == b["step"] == 4
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert all(torch.equal(a["ema_params"][k], b["ema_params"][k]) for k in a["ema_params"])
