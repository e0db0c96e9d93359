"""Train state: the trainable parameters, the optimizer's state and the EMA
shadow, updated in place.

Counterpart of ``prediff_tpu/training/train_state.py``.  Where the flax
state is an immutable pytree that each step replaces, this one holds the
live ``nn.Parameter``s (the UNet's, and ``logvar`` when it is learned) and
mutates them; ``apply_gradients`` returns the same object.  As there, every
call counts as a step and moves the EMA, also the calls between two
optimizer updates of an accumulated batch.

On several ranks each holds the whole state: :meth:`replicate` sets it to the
mesh's first rank's after it is made (the JAX state is put replicated), and
the same reduced gradients on every rank then keep the parameters, the EMA
and the optimizer's moments bit-equal; a restore reads the same file on every
rank.
"""
from typing import Dict, Optional, Sequence

import torch
from torch import nn
from torch.autograd.graph import increment_version

from ..parallel.mesh import DataMesh, replicate_
from .ema import ema_decay, ema_update
from .optim import Optimizer, state_dtype_of


def param_grads(loss: torch.Tensor, params: Sequence[torch.Tensor]) -> list:
    """``torch.autograd.grad`` of ``loss`` for each of ``params``, zeros for
    a parameter the loss does not reach (the last block's global-vector
    layers of a UNet feed nothing; ``jax.grad`` gives them zeros)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class EmaTrainState:
    def __init__(self, params: Dict[str, nn.Parameter], tx: Optimizer, use_ema: bool = True,
                 ema_decay: float = 0.9999, ema_dtype: Optional[str] = None):
        self.step = 0
        self.params = params        # name -> live parameter, "unet.<path>" and "logvar"
        self.tx = tx
        self.use_ema = use_ema
        self.ema_decay = ema_decay
        dtype = state_dtype_of(ema_dtype)
        # own copies: the shadow never aliases a parameter
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {k: p.detach().to(dtype or p.dtype, copy=True) for k, p in params.items()}
            if use_ema else None)
        # 1 - the ramped decay of the next EMA move, on the parameters' device
        # (load_scalars): what the shadow moves by
        first = next(iter(params.values()), None)
        self.ema_w = torch.zeros((), dtype=torch.float32,
                                 device=None if first is None else first.device)

    @classmethod
    def create(cls, params: Dict[str, nn.Parameter], tx: Optimizer, use_ema: bool = True,
               ema_decay: float = 0.9999, ema_dtype: Optional[str] = None) -> "EmaTrainState":
        """``tx`` must have been built over ``params.values()`` in this order.
        ``ema_dtype`` (None, or "bfloat16", "float16", "float32"): the EMA
        shadow stored in that dtype, moved in the parameters' (``ema_update``)."""
        if [id(p) for p in tx.params] != [id(p) for p in params.values()]:
            raise ValueError("the optimizer was built over other parameters than the state's")
        return cls(params, tx, use_ema=use_ema, ema_decay=ema_decay, ema_dtype=ema_dtype)

    def tensors(self) -> list:
        """Every tensor of the state: the parameters, the EMA shadow, the
        optimizer's moments and its accumulated gradients."""
        out = list(self.params.values()) + list((self.ema_params or {}).values())
        for st in self.tx.optimizer.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        return out + list(self.tx.acc_grads or [])

    def replicate(self, mesh: Optional[DataMesh]) -> "EmaTrainState":
        """Every tensor of the state set in place to the mesh's first rank's
        (one broadcast a dtype); nothing without a mesh.  Every rank calls it
        on a state of the same make."""
        replicate_(self.tensors(), mesh)
        return self

    def counters(self) -> tuple:
        """The host's counters a micro-step moves: ``step`` and the
        optimizer's ``count`` and ``mini_step`` (:meth:`set_counters` puts
        them back)."""
        return self.step, self.tx.count, self.tx.mini_step

    def set_counters(self, counters: tuple) -> None:
        self.step, self.tx.count, self.tx.mini_step = counters

    def scalar_tensors(self) -> list:
        """The device scalars :meth:`load_scalars` fills: the optimizer's and
        the EMA's weight."""
        return self.tx.scalar_tensors() + [self.ema_w]

    def load_scalars(self) -> None:
        """The next micro-step's device scalars from the host's counters: the
        optimizer's (``Optimizer.load_scalars``) and the EMA's weight, no sync."""
        self.tx.load_scalars()
        if self.use_ema:
            self.ema_w.fill_(1.0 - ema_decay(self.ema_decay, self.step))

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> "EmaTrainState":
        """One micro-gradient, in the order of ``params``: the optimizer
        (which moves the parameters once every ``accum_steps`` calls), then
        the EMA with the step count before the increment."""
        self.load_scalars()
        return self.apply_loaded(grads)

    def apply_loaded(self, grads: Sequence[torch.Tensor]) -> "EmaTrainState":
        """:meth:`apply_gradients` on the device scalars as loaded
        (:meth:`load_scalars`); what a captured micro-step records."""
        self.tx.apply(grads)
        if self.use_ema:
            ema_update(list(self.ema_params.values()), list(self.params.values()),
                       self.ema_decay, self.step, self.ema_w)
        self.step += 1
        return self

    def advance(self) -> None:
        """The host's counters past one micro-step whose device work ran as a
        replay (``training/step_graphs.py``): the optimizer's, ``step``, and
        the version counters of what the step moved (the parameters on an
        update, the shadow every step), which a replay does not bump."""
        self.tx.advance()
        for e in (self.ema_params or {}).values():
            increment_version(e)
        self.step += 1

    def ema_param_tree(self, prefix: str = "") -> Optional[Dict[str, torch.Tensor]]:
        """The EMA shadow, name -> tensor; with ``prefix`` only the names
        under it, the prefix cut (``"unet."`` gives what
        ``torch.func.functional_call`` takes for the UNet).  A shadow stored
        in ``ema_dtype`` comes widened to each parameter's dtype."""
        if self.ema_params is None:
            return None
        return {k[len(prefix):]: v.to(self.params[k].dtype) for k, v in self.ema_params.items()
                if k.startswith(prefix)}

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "params": {k: p.detach() for k, p in self.params.items()},
                "opt_state": self.tx.state_dict(),
                "ema_params": self.ema_params}

    def load_state_dict(self, state: Dict) -> None:
        """Restore in place; the names must be this state's, and the shadow's
        and the moments' dtypes (a low-precision state and an f32 one are not
        interchangeable: ``ValueError``)."""
        if set(state["params"]) != set(self.params):
            raise ValueError("checkpoint holds other parameters than this train state")
        if (state["ema_params"] is None) != (self.ema_params is None):
            raise ValueError("checkpoint and train state differ in use_ema")
        for k, e in (self.ema_params or {}).items():
            if state["ema_params"][k].dtype != e.dtype:
                raise ValueError(f"checkpoint holds the EMA shadow in "
                                 f"{state['ema_params'][k].dtype}, this state in {e.dtype}")
        self.tx.load_state_dict(state["opt_state"])   # checks the moments before it loads
        self.step = int(state["step"])
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(state["params"][k])
            if self.ema_params is not None:
                for k, e in self.ema_params.items():
                    e.copy_(state["ema_params"][k])
