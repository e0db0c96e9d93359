"""Knowledge alignment: a classifier-guidance mean shift from the trained
energy model U(z_t, t).

Counterpart of ``prediff_tpu/diffusion/knowledge_alignment.py`` (reference
SEVIRAvgIntensityAlignment, sevir.py:7; get_sample_align_fn,
alignment_pl.py:423).  The guidance gradient is ``torch.autograd.grad`` of
the squared error with respect to z_t, with the explicit chain rule of the
JAX package's ``_shift_impl``: grad(sq) / (2 sqrt(sq + 1e-24)).  Under that
gradient every kernel of the alignment net runs its input-gradient kernel.

``compute_dtype`` follows the JAX package's rule (``get_mean_shift``): where
it differs from z_t's dtype the net runs on a copy of its parameters in that
dtype (``utils.precision.LowCopy``: one copy per parameter version) and on
z_t cast to it, and the shift comes back in z_t's dtype; where it is z_t's
dtype the net keeps its own parameters, which promote with z_t as flax
promotes (``utils.precision.Promoted``): a bf16 net on an f32 z_t runs in f32
on a copy of its bf16 parameters in f32.  In bf16 the net's kernels run their
bf16 forms.  The scalar tail stays f32 in every case: grad(sq) in the dtype
of the z it was taken for, divided by the f32 sqrt in f32.

With a ``mesh`` (``parallel.DataMesh``: each rank holds its rows of the
batch) the squared error is summed over the ranks before the sqrt, since the
energy couples the whole batch: E = sqrt(sum over ranks of sq_local + 1e-24)
and dE/dz_local = grad(sq_local) / (2 E).  The all-reduce is of the detached
f32 ``sq_local``: autograd never goes through the collective (the JAX package
measured the gradient 8x too large on 8 devices when it did,
``prediff_tpu/diffusion/knowledge_alignment.py:76-85``).  Without a mesh
nothing changes, bit for bit.
"""
from typing import Dict, List, Optional

import torch
from torch import nn

from ..parallel.mesh import DataMesh, all_reduce_sum
from ..utils.precision import Promoted, dtype_name, param_dtype, resolve_dtype


def avg_x_objective(x: torch.Tensor) -> torch.Tensor:
    """Per-frame mean intensity target: (B,T,H,W,C) -> (B,T,1)."""
    return x.mean(dim=(2, 3, 4))[..., None]


class KnowledgeAlignment:
    """The alignment model (an ``nn.Module`` U(z_t, t) -> (B, T, 1)) and the
    guidance scale.  ``alignment_energy`` averages U's per-frame readout over
    T and takes an L2 norm against ``avg_x_gt`` over all elements, batch
    included, as the reference does."""

    def __init__(self, model: nn.Module, guide_scale: float = 1.0,
                 alignment_type: str = "avg_x", compute_dtype: str = "float32"):
        if alignment_type != "avg_x":
            raise NotImplementedError(f"alignment type '{alignment_type}' is not ported")
        self.dtype = resolve_dtype(compute_dtype, "guidance compute_dtype")
        self.model = model
        self.guide_scale = guide_scale
        self.alignment_type = alignment_type
        self.compute_dtype = dtype_name(self.dtype)
        self._promoted = Promoted(model)
        self._low = self._promoted.low(self.dtype)

    def _cast_net(self) -> nn.Module:
        """The net in the guidance dtype: itself where its parameters are in
        it, else its copy, brought up to date with the parameters."""
        return self._promoted.get(self.dtype)

    def modules(self, zt_dtype: torch.dtype) -> List[nn.Module]:
        """The modules whose tensors guidance reads for a carry of
        ``zt_dtype``, a copy brought up to date: what a captured guided step
        bakes in."""
        net = (self._promoted.for_input(zt_dtype) if self.dtype == zt_dtype
               else self._cast_net())
        return list({id(m): m for m in (self.model, net)}.values())

    def tracked(self) -> List[nn.Module]:
        """The net and, once made, its copies in other dtypes."""
        return [self.model] + self._promoted.copies()

    def predict(self, zt: torch.Tensor, t: torch.Tensor, zc=None, y=None,
                net: nn.Module = None) -> torch.Tensor:
        """U(z_t, t); ``zc`` and ``y`` are accepted and ignored, as the
        reference's alignment net ignores them.  As flax promotes, the net
        runs in ``promote(z_t dtype, parameter dtype)``: z_t is widened where
        the parameters are wider, and the net (``net`` or its own) runs on
        its copy in z_t's dtype where z_t is."""
        if net is None or net is self.model:
            net = self._promoted.for_input(zt.dtype)
        return net(zt.to(torch.promote_types(zt.dtype, param_dtype(net))), t)

    def _sq_error(self, zt, t, avg_x_gt, zc=None, y=None, net=None) -> torch.Tensor:
        """The JAX package's ``_sq_error``: the readout's mean over axis 1
        against the target.  A per-frame readout (B, T, C) gives (B, C); a
        pooled one (``readout_seq=False``, (B, C)) gives (B,), which
        broadcasts against the (B, 1) target to (B, B), as it does there."""
        pred = self.predict(zt, t, zc=zc, y=y, net=net).float().mean(dim=1)   # (B, 1)
        return (pred - avg_x_gt.float()).square().sum()

    def alignment_energy(self, zt, t, avg_x_gt, zc=None, y=None,
                         mesh: Optional[DataMesh] = None) -> torch.Tensor:
        """The energy; with ``mesh`` the whole batch's, z_t being this rank's
        rows (the squared error all-reduced before the sqrt), a value that
        autograd does not go through (``get_mean_shift`` gives its
        gradient)."""
        sq = self._sq_error(zt, t, avg_x_gt, zc=zc, y=y)
        if mesh is not None:
            sq = all_reduce_sum(sq.detach().float(), mesh)
        return torch.sqrt(sq + 1e-24)

    def get_mean_shift(self, zt, t, avg_x_gt, zc=None, y=None,
                       mesh: Optional[DataMesh] = None) -> torch.Tensor:
        """guide_scale * d(energy)/d(z_t), taken by autograd whatever the
        caller's grad mode: in z_t's dtype where the guidance dtype differs
        from it, else in the promotion of z_t's dtype and f32, as the JAX
        package returns it.  With ``mesh`` z_t is this rank's rows and the
        energy the whole batch's (the module's note)."""
        if self.dtype != zt.dtype:
            zc = None if zc is None else zc.to(self.dtype)
            shift = self._shift(zt.to(self.dtype), t, avg_x_gt, zc, y, self._cast_net(), mesh)
            return self.guide_scale * shift.to(zt.dtype)
        return self.guide_scale * self._shift(zt, t, avg_x_gt, zc, y, self.model, mesh)

    def _shift(self, zt, t, avg_x_gt, zc, y, net, mesh=None) -> torch.Tensor:
        with torch.enable_grad():
            z = zt.detach().requires_grad_(True)
            sq = self._sq_error(z, t, avg_x_gt, zc=zc, y=y, net=net)
            (grad_sq,) = torch.autograd.grad(sq, z)
        sq = sq.detach()
        if mesh is not None:   # the batch's energy: every rank's sum, no autograd through it
            sq = all_reduce_sum(sq, mesh)
        # a 0-d f32 tensor does not promote a bf16 one in torch; in JAX it does
        return grad_sq.float() / (2.0 * torch.sqrt(sq + 1e-24))


def get_alignment_kwargs_avg_x(target_seq: torch.Tensor,
                               multiplier: float = 2.0) -> Dict[str, torch.Tensor]:
    """Demonstration knowledge: ``multiplier`` x the future's mean intensity,
    (B, 1)."""
    B = target_seq.shape[0]
    return {"avg_x_gt": target_seq.reshape(B, -1).mean(dim=1, keepdim=True) * multiplier}
