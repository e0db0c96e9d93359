"""LPIPS perceptual distance: VGG16 feature slices and learned 1x1 heads.

Counterpart of ``prediff_tpu/training/lpips.py`` (reference
taming/losses/lpips.py).  Inputs are NHWC images in [-1, 1] with 3
channels; inside, the network runs NCHW.  Module names mirror torchvision's
``vgg16().features`` indices within each slice (``net.slice1.0``,
``net.slice3.14``) and the reference's heads (``lin0.model.1``), so the
bridge maps them to the flax names.  The published VGG16 and LPIPS weights
are not in the repository: the weights come from ``init_params_`` (flax's
default initialisation, as the JAX module's) or from a state_dict.  The v1
recipe trains with ``perceptual_weight=0``, so the VAE-GAN trainer runs
without it.
"""
from collections import OrderedDict

import torch
from torch import nn

# torchvision vgg16 .features indices: each slice's layers, "M" a max-pool
_SLICES = (
    ((0, 64), (2, 64)),
    ("M", (5, 128), (7, 128)),
    ("M", (10, 256), (12, 256), (14, 256)),
    ("M", (17, 512), (19, 512), (21, 512)),
    ("M", (24, 512), (26, 512), (28, 512)),
)
LPIPS_CHNS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Module):
    """The five slices, returning (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3)."""

    def __init__(self):
        super().__init__()
        in_ch, first = 3, 0
        for s, layers in enumerate(_SLICES):
            mods, idx = OrderedDict(), first
            for layer in layers:
                if layer == "M":
                    mods[str(idx)] = nn.MaxPool2d(2, stride=2)
                    idx += 1
                    continue
                conv_idx, ch = layer
                mods[str(conv_idx)] = nn.Conv2d(in_ch, ch, 3, padding=1)
                mods[str(conv_idx + 1)] = nn.ReLU()
                in_ch, idx = ch, conv_idx + 2
            setattr(self, f"slice{s + 1}", nn.Sequential(mods))
            first = idx

    def forward(self, x: torch.Tensor):
        outs = []
        for s in range(len(_SLICES)):
            x = getattr(self, f"slice{s + 1}")(x)
            outs.append(x)
        return tuple(outs)


class NetLinLayer(nn.Module):
    """1x1 conv head at ``model.1``; slot 0 stands for the reference's
    dropout, inactive in the eval mode the loss runs in."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPS(nn.Module):
    """Learned perceptual distance between NHWC images: (B, 1, 1, 1)."""
    # seeded initialisation: flax's default (lecun_normal), as the JAX module's nn.Conv
    FLAX_DEFAULT_INIT = True

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).reshape(1, 3, 1, 1),
                             persistent=False)
        self.net = VGG16Features()
        for k, ch in enumerate(LPIPS_CHNS):
            setattr(self, f"lin{k}", NetLinLayer(ch))

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        def features(x):
            return self.net((x.permute(0, 3, 1, 2) - self.shift) / self.scale)

        def unit_normalize(x, eps=1e-10):
            return x / (torch.sqrt(x.square().sum(dim=1, keepdim=True)) + eps)

        val = 0.0
        for k, (f0, f1) in enumerate(zip(features(input), features(target))):
            diff = (unit_normalize(f0) - unit_normalize(f1)).square()
            val = val + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3), keepdim=True)
        return val
