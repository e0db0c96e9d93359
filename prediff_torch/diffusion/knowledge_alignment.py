"""Knowledge alignment: a classifier-guidance mean shift from the trained
energy model U(z_t, t).

Counterpart of ``prediff_tpu/diffusion/knowledge_alignment.py`` (reference
SEVIRAvgIntensityAlignment, sevir.py:7; get_sample_align_fn,
alignment_pl.py:423).  The guidance gradient is ``torch.autograd.grad`` of
the squared error with respect to z_t, with the explicit chain rule of the
JAX package's ``_shift_impl``: grad(sq) / (2 sqrt(sq + 1e-24)).  Under that
gradient every kernel of the alignment net runs its input-gradient kernel.
"""
from typing import Dict

import torch
from torch import nn


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
        if compute_dtype == "auto":   # the JAX package's resolution off a TPU
            compute_dtype = "float32"
        if compute_dtype != "float32":
            raise NotImplementedError(
                f"guidance compute_dtype {compute_dtype!r}: only float32 is ported (ROADMAP.md "
                "queue 1, compute_dtype='bfloat16' for the chain and for guidance)")
        self.model = model
        self.guide_scale = guide_scale
        self.alignment_type = alignment_type
        self.compute_dtype = compute_dtype

    def predict(self, zt: torch.Tensor, t: torch.Tensor, zc=None, y=None) -> torch.Tensor:
        """U(z_t, t); ``zc`` and ``y`` are accepted and ignored, as the
        reference's alignment net ignores them."""
        return self.model(zt, t)

    def _sq_error(self, zt, t, avg_x_gt, zc=None, y=None) -> torch.Tensor:
        pred = self.predict(zt, t, zc=zc, y=y).float().mean(dim=1)   # (B, 1)
        return (pred - avg_x_gt.float()).square().sum()

    def alignment_energy(self, zt, t, avg_x_gt, zc=None, y=None) -> torch.Tensor:
        return torch.sqrt(self._sq_error(zt, t, avg_x_gt, zc=zc, y=y) + 1e-24)

    def get_mean_shift(self, zt, t, avg_x_gt, zc=None, y=None) -> torch.Tensor:
        """guide_scale * d(energy)/d(z_t), taken by autograd whatever the
        caller's grad mode."""
        with torch.enable_grad():
            z = zt.detach().requires_grad_(True)
            sq = self._sq_error(z, t, avg_x_gt, zc=zc, y=y)
            (grad_sq,) = torch.autograd.grad(sq, z)
        return self.guide_scale * (grad_sq / (2.0 * torch.sqrt(sq.detach() + 1e-24)))


def get_alignment_kwargs_avg_x(target_seq: torch.Tensor,
                               multiplier: float = 2.0) -> Dict[str, torch.Tensor]:
    """Demonstration knowledge: ``multiplier`` x the future's mean intensity,
    (B, 1)."""
    B = target_seq.shape[0]
    return {"avg_x_gt": target_seq.reshape(B, -1).mean(dim=1, keepdim=True) * multiplier}
