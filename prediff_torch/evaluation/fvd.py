"""Fréchet Video Distance with an Inception-v1 I3D feature extractor.

Counterpart of ``prediff_tpu/evaluation/fvd.py`` (reference
FrechetVideoDistance, evaluation/fvd/torchmetrics_wrap.py:84; InceptionI3d,
pytorch_i3d.py:133; the Fréchet math, fvd/fvd.py:52-121).  The module runs
NCDHW inside and takes (B, T, H, W, C) at its boundary.  Its attribute names
are the flax module names (``Conv3d_1a_7x7.conv3d.weight``,
``Mixed_3b.b1a.bn.running_mean``, ``logits.conv3d.bias``), so
``utils.convert.flax_params_to_torch(model, params, batch_stats)`` carries a
flax tree over unchanged.  Padding is TF-style dynamic SAME with zeros, before
the max-pools too, as ``jnp.pad`` pads.  Features accumulate as streaming f32
(sum, cov_sum, n) on the device; the moments and the distance are float64 on
the host (numpy's SVD).
"""
import copy
import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import f32_numerics


def _same_pad_3d(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """TF-style dynamic SAME padding with zeros over (B, C, T, H, W)."""
    pads = []
    for d, size in enumerate(x.shape[2:5]):
        if size % stride[d] == 0:
            pad = max(kernel[d] - stride[d], 0)
        else:
            pad = max(kernel[d] - (size % stride[d]), 0)
        pads.append((pad // 2, pad - pad // 2))
    # F.pad takes its pairs last axis first
    return F.pad(x, [p for pair in reversed(pads) for p in pair])


class MaxPool3dSamePadding(nn.Module):
    def __init__(self, kernel_size: Tuple[int, int, int], stride: Tuple[int, int, int]):
        super().__init__()
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)

    def forward(self, x):
        return F.max_pool3d(_same_pad_3d(x, self.kernel_size, self.stride), self.kernel_size,
                            self.stride)


class Unit3D(nn.Module):
    """SAME-padded conv (no bias unless asked), BatchNorm (eps 1e-5), ReLU."""

    def __init__(self, in_channels: int, output_channels: int,
                 kernel_shape: Tuple[int, int, int] = (1, 1, 1),
                 stride: Tuple[int, int, int] = (1, 1, 1), use_batch_norm: bool = True,
                 use_bias: bool = False, use_activation: bool = True):
        super().__init__()
        self.kernel_shape, self.stride = tuple(kernel_shape), tuple(stride)
        self.conv3d = nn.Conv3d(in_channels, output_channels, self.kernel_shape, self.stride,
                                bias=use_bias)
        # flax's momentum 0.999 keeps 0.999 of the running statistics
        self.bn = nn.BatchNorm3d(output_channels, eps=1e-5, momentum=1e-3) \
            if use_batch_norm else None
        self.use_activation = use_activation

    def forward(self, x):
        x = self.conv3d(_same_pad_3d(x, self.kernel_shape, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.use_activation else x


class InceptionModule(nn.Module):
    def __init__(self, in_channels: int, out_channels: Sequence[int]):
        super().__init__()
        oc = tuple(out_channels)
        self.b0 = Unit3D(in_channels, oc[0], (1, 1, 1))
        self.b1a = Unit3D(in_channels, oc[1], (1, 1, 1))
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, oc[3], (1, 1, 1))
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3))
        self.b3a = MaxPool3dSamePadding((3, 3, 3), (1, 1, 1))
        self.b3b = Unit3D(in_channels, oc[5], (1, 1, 1))
        self.out_channels = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(self.b3a(x))], dim=1)


# (name, output channels of each branch: b0, b1a, b1b, b2a, b2b, b3b)
_MIXED = {"Mixed_3b": (64, 96, 128, 16, 32, 32), "Mixed_3c": (128, 128, 192, 32, 96, 64),
          "Mixed_4b": (192, 96, 208, 16, 48, 64), "Mixed_4c": (160, 112, 224, 24, 64, 64),
          "Mixed_4d": (128, 128, 256, 24, 64, 64), "Mixed_4e": (112, 144, 288, 32, 64, 64),
          "Mixed_4f": (256, 160, 320, 32, 128, 128), "Mixed_5b": (256, 160, 320, 32, 128, 128),
          "Mixed_5c": (384, 192, 384, 48, 128, 128)}


class InceptionI3d(nn.Module):
    """Inception-v1 I3D over (B, T, H, W, in_channels) in [-1, 1]; returns
    per-video logits (B, num_classes), time-averaged.  The head's average
    pool window (2, 7, 7) is clamped to the feature map, as in the JAX
    package, so inputs below 224x224 or short in T stay usable (the
    reference torch version errors there)."""

    def __init__(self, num_classes: int = 400, dropout_keep_prob: float = 0.5,
                 in_channels: int = 3):
        super().__init__()
        self.num_classes = num_classes
        self.dropout_keep_prob = dropout_keep_prob   # kept for the signature: no dropout
        self.Conv3d_1a_7x7 = Unit3D(in_channels, 64, (7, 7, 7), stride=(2, 2, 2))
        self.MaxPool3d_2a_3x3 = MaxPool3dSamePadding((1, 3, 3), (1, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64, (1, 1, 1))
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        self.MaxPool3d_3a_3x3 = MaxPool3dSamePadding((1, 3, 3), (1, 2, 2))
        c = 192
        for name, oc in _MIXED.items():
            if name == "Mixed_4b":
                self.MaxPool3d_4a_3x3 = MaxPool3dSamePadding((3, 3, 3), (2, 2, 2))
            if name == "Mixed_5b":
                self.MaxPool3d_5a_2x2 = MaxPool3dSamePadding((2, 2, 2), (2, 2, 2))
            setattr(self, name, InceptionModule(c, oc))
            c = getattr(self, name).out_channels
        self.logits = Unit3D(c, num_classes, (1, 1, 1), use_batch_norm=False, use_bias=True,
                             use_activation=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 4, 1, 2, 3)   # (B, T, H, W, C) -> NCDHW
        x = self.Conv3d_1a_7x7(x)
        x = self.MaxPool3d_2a_3x3(x)
        x = self.Conv3d_2b_1x1(x)
        x = self.Conv3d_2c_3x3(x)
        x = self.MaxPool3d_3a_3x3(x)
        for name in _MIXED:
            if name == "Mixed_4b":
                x = self.MaxPool3d_4a_3x3(x)
            if name == "Mixed_5b":
                x = self.MaxPool3d_5a_2x2(x)
            x = getattr(self, name)(x)
        window = tuple(min(k, s) for k, s in zip((2, 7, 7), x.shape[2:5]))
        x = self.logits(F.avg_pool3d(x, window, stride=1))
        if x.shape[3:5] != (1, 1):
            raise ValueError(f"the head leaves a {tuple(x.shape[3:5])} map: inputs above 224x224 "
                             "are not taken")
        return x[:, :, :, 0, 0].mean(dim=2)


def seeded_i3d(num_classes: int = 400, seed: int = 0) -> InceptionI3d:
    """An eval-mode ``InceptionI3d`` with seeded random weights that carry
    the input's signal through its 20-odd layers: convolutions He-normal
    (ReLU's gain), BatchNorm near the identity (running variances in
    [0.8, 1.2], scales near 1), means and biases small.  The published
    Kinetics weights are not in the repository; an FVD on these weights
    checks the wiring, its value means nothing."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionI3d(num_classes=num_classes)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv3d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=gen))
            elif isinstance(m, nn.BatchNorm3d):
                m.weight.copy_(1.0 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=gen))
                m.running_mean.copy_(0.01 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(0.8 + 0.4 * torch.rand(m.running_var.shape, generator=gen))
    return model.eval()


def preprocess_video(video: torch.Tensor, target_resolution: int = 224) -> torch.Tensor:
    """(B, T, H, W, C) in [0,1] -> resized (bilinear, antialiased when it
    shrinks, as ``jax.image.resize``), center-cropped, in [-1, 1]
    (parity: I3DWrapper.preprocess, torchmetrics_wrap.py:33-62)."""
    B, T, H, W, C = video.shape
    scale = target_resolution / min(H, W)
    if H < W:
        th, tw = target_resolution, math.ceil(W * scale)
    else:
        th, tw = math.ceil(H * scale), target_resolution
    frames = video.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
    frames = F.interpolate(frames, size=(th, tw), mode="bilinear", align_corners=False,
                           antialias=True)
    h0 = (th - target_resolution) // 2
    w0 = (tw - target_resolution) // 2
    frames = frames[:, :, h0:h0 + target_resolution, w0:w0 + target_resolution]
    frames = frames.permute(0, 2, 3, 1).reshape(B, T, target_resolution, target_resolution, C)
    return (frames - 0.5) * 2.0


@dataclass
class FVDState:
    features_sum: torch.Tensor      # (d,) f32
    features_cov_sum: torch.Tensor  # (d, d) f32
    num_samples: torch.Tensor       # () int32

    @classmethod
    def zeros(cls, d: int, dtype=torch.float32) -> "FVDState":
        return cls(features_sum=torch.zeros((d,), dtype=dtype),
                   features_cov_sum=torch.zeros((d, d), dtype=dtype),
                   num_samples=torch.zeros((), dtype=torch.int32))

    def to(self, device) -> "FVDState":
        return FVDState(self.features_sum.to(device), self.features_cov_sum.to(device),
                        self.num_samples.to(device))

    def update(self, features: torch.Tensor) -> "FVDState":
        """The state with ``features`` (N, d) added, on their device."""
        s = self.to(features.device)
        with f32_numerics():
            cov = features.T @ features
        return FVDState(features_sum=s.features_sum + features.sum(dim=0),
                        features_cov_sum=s.features_cov_sum + cov,
                        num_samples=s.num_samples + features.shape[0])

    def merge(self, other: "FVDState") -> "FVDState":
        """The sums of the two states, on this state's device."""
        other = other.to(self.features_sum.device)
        return FVDState(features_sum=self.features_sum + other.features_sum,
                        features_cov_sum=self.features_cov_sum + other.features_cov_sum,
                        num_samples=self.num_samples + other.num_samples)

    def mean_cov(self):
        n = float(self.num_samples)
        mean = self.features_sum.cpu().numpy().astype(np.float64) / n
        cov = (self.features_cov_sum.cpu().numpy().astype(np.float64)
               - n * np.outer(mean, mean)) / (n - 1)
        return mean, cov


def _sym_matrix_sqrt(mat: np.ndarray, eps: float = 1e-10) -> np.ndarray:
    u, s, vt = np.linalg.svd(mat)
    si = np.where(s < eps, s, np.sqrt(s))
    return u @ np.diag(si) @ vt


def frechet_distance_from_moments(m1, c1, m2, c2) -> float:
    sqrt_c1 = _sym_matrix_sqrt(c1)
    inner = _sym_matrix_sqrt(sqrt_c1 @ c2 @ sqrt_c1)
    trace = np.trace(c1 + c2) - 2.0 * np.trace(inner)
    return float(trace + np.sum((m1 - m2) ** 2))


def frechet_distance(x1: np.ndarray, x2: np.ndarray) -> float:
    """FVD between two (N, d) feature batches, float64 (parity: fvd/fvd.py:101-112)."""
    x1 = np.asarray(x1, np.float64).reshape(len(x1), -1)
    x2 = np.asarray(x2, np.float64).reshape(len(x2), -1)
    m1, m2 = x1.mean(0), x2.mean(0)
    c1 = np.cov(x1, rowvar=False)
    c2 = np.cov(x2, rowvar=False)
    return frechet_distance_from_moments(m1, c1, m2, c2)


def i3d_feature_fn(model: InceptionI3d, target_resolution: int = 224
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Videos (B, T, H, W, 3) in [0, 1] -> the I3D's (B, num_classes)
    features, on the videos' device (one eval-mode copy of ``model`` per
    device), under ``torch.inference_mode`` with TF32 off.  One such
    function can serve several ``FrechetVideoDistance`` instances (the
    aligned and unaligned suites)."""
    copies = {}

    def feature_fn(videos: torch.Tensor) -> torch.Tensor:
        net = copies.get(videos.device)
        if net is None:
            net = copies[videos.device] = copy.deepcopy(model).to(videos.device).eval()
        with torch.inference_mode(), f32_numerics():
            return net(preprocess_video(videos, target_resolution))

    return feature_fn


class FrechetVideoDistance:
    """Streaming FVD: ``update(videos, real=...)`` -> ``compute()``.

    videos: (B, T, H, W, C) in [0, 1] (or 0-255 with ``normalize``); C=1 is
    tiled to 3; T < 9 repeat-interleaved when ``auto_t``.  The extractor is
    ``feature_fn`` as given, or an ``InceptionI3d(num_features)`` with the
    state dict ``i3d_params``."""

    min_t = 9

    def __init__(self, feature_fn: Optional[Callable] = None, num_features: int = 400,
                 i3d_params=None, reset_real_features: bool = True, normalize: bool = False,
                 auto_t: bool = False, target_resolution: int = 224):
        if feature_fn is None:
            if i3d_params is None:
                raise ValueError("provide the I3D's state dict (i3d_params) or a feature_fn")
            model = InceptionI3d(num_classes=num_features)
            model.load_state_dict(i3d_params)
            feature_fn = i3d_feature_fn(model, target_resolution)
        self.feature_fn = feature_fn
        self.num_features = num_features
        self.reset_real_features = reset_real_features
        self.normalize = normalize
        self.auto_t = auto_t
        self.real = FVDState.zeros(num_features)
        self.fake = FVDState.zeros(num_features)

    def update(self, videos: torch.Tensor, real: bool):
        if videos.shape[1] < self.min_t:
            if not self.auto_t:
                raise ValueError(f"temporal length {videos.shape[1]} < {self.min_t}; "
                                 "set auto_t=True to repeat-interleave")
            # repeat-interleave until >= min_t (the reference repeats once,
            # the same factor for every T in [5, 9))
            reps = -(-self.min_t // videos.shape[1])
            videos = torch.repeat_interleave(videos, reps, dim=1)
        if self.normalize:
            videos = videos / 255.0
        if videos.shape[-1] == 1:
            videos = videos.repeat(1, 1, 1, 1, 3)
        features = self.feature_fn(videos)
        if real:
            self.real = self.real.update(features)
        else:
            self.fake = self.fake.update(features)

    def compute(self) -> float:
        m_r, c_r = self.real.mean_cov()
        m_f, c_f = self.fake.mean_cov()
        return frechet_distance_from_moments(m_r, c_r, m_f, c_f)

    def reset(self):
        self.fake = FVDState.zeros(self.num_features)
        if self.reset_real_features:
            self.real = FVDState.zeros(self.num_features)
