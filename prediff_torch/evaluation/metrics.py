"""Generic eval metrics: MSE / MAE / SSIM, ensemble CRPS and Pearson
correlation on tensors of any device, computed on that device.

Counterpart of ``prediff_tpu/evaluation/metrics.py``.  ``ssim`` keeps the
torchmetrics ``StructuralSimilarityIndexMeasure()`` defaults the reference
logs: a gaussian 11x11 window of sigma 1.5 (built in f32), biased second
moments, windows fully inside the image (a valid-mode depthwise filter) and
``data_range`` inferred per update as the larger of the two ranges.  The
filter is ``F.conv2d(groups=C)`` on NCHW with TF32 off.  CRPS is the fair
ensemble estimator.
"""
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..utils.device import f32_numerics


class MeanMetric:
    """Streaming mean with explicit (total, count) state, accumulated on the
    host as Python floats: each update reads its value back (one device sync
    per update, as the JAX package's ``float(jnp.sum(value))``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total = 0.0
        self.count = 0.0

    def update(self, value: Union[torch.Tensor, float], weight: Optional[float] = None):
        """Accumulate ``value`` with ``weight`` = the number of elements the
        (possibly already reduced) value represents; defaults to its number
        of elements.  A batch-mean scalar passes its element count, so ragged
        final batches weigh by their true size (torchmetrics' semantics)."""
        value = torch.as_tensor(value)
        v = float(value.sum())
        n = max(value.numel(), 1)
        w = float(weight) if weight is not None else float(n)
        self.total += (v / n) * w
        self.count += w

    def merge(self, other: "MeanMetric"):
        """Sum states (shard / cross-process reduction)."""
        self.total += other.total
        self.count += other.count

    def compute(self) -> float:
        return self.total / max(self.count, 1e-12)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def _window_filter_2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode per-channel 2-D window filter over (B, H, W, C)."""
    C = x.shape[-1]
    k = kernel.to(x.dtype)[None, None].expand(C, 1, -1, -1)
    with f32_numerics():
        out = F.conv2d(x.permute(0, 3, 1, 2), k, groups=C)
    return out.permute(0, 2, 3, 1)


def _ssim_window(kernel_size: int, sigma: Optional[float], device=None) -> torch.Tensor:
    """Normalized 2-D window in f32: separable gaussian (sigma given) or uniform."""
    if sigma is None:
        return torch.full((kernel_size, kernel_size), 1.0 / kernel_size**2, device=device)
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return g[:, None] * g[None, :]


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: Optional[float] = None,
         kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         gaussian_kernel: bool = True) -> torch.Tensor:
    """SSIM over (B, H, W, C) frames, mean-reduced (a 0-dim tensor).
    ``gaussian_kernel=False`` takes the uniform window."""
    if data_range is None:
        data_range = torch.maximum(pred.max() - pred.min(), target.max() - target.min())
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    window = _ssim_window(kernel_size, sigma if gaussian_kernel else None, pred.device)
    mu_x = _window_filter_2d(pred, window)
    mu_y = _window_filter_2d(target, window)
    mu_xx = _window_filter_2d(pred * pred, window)
    mu_yy = _window_filter_2d(target * target, window)
    mu_xy = _window_filter_2d(pred * target, window)
    # biased second moments (torchmetrics applies no n/(n-1) correction)
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x**2 + mu_y**2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def crps_ensemble(ensemble: torch.Tensor, target: torch.Tensor, fair: bool = True
                  ) -> torch.Tensor:
    """Ensemble CRPS of members ``ensemble`` (M, ...) against ``target`` (...):
    E|X - y| - 0.5 E|X - X'| (fair: / M(M-1); else / M^2), mean over the
    target's elements."""
    M = ensemble.shape[0]
    term1 = torch.mean(torch.abs(ensemble - target[None]), dim=0)
    diffs = torch.abs(ensemble[:, None] - ensemble[None, :])  # (M, M, ...)
    denom = M * (M - 1) if fair and M > 1 else M * M
    term2 = 0.5 * torch.sum(diffs, dim=(0, 1)) / denom
    return torch.mean(term1 - term2)


def pearson_corr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = pred.reshape(-1) - pred.mean()
    t = target.reshape(-1) - target.mean()
    return torch.sum(p * t) / (torch.sqrt(torch.sum(p * p)) * torch.sqrt(torch.sum(t * t))
                               + 1e-12)
