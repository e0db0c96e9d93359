"""Frame-wise KL autoencoder: ``encode_moments`` and ``decode`` for the
diffusion pipeline, ``encode`` (the posterior), ``decode_with_features`` and
``forward`` for the VAE-GAN trainer.

Public functions take and return NHWC frames; inside, the network runs NCHW
on PyTorch's convolutions, GroupNorms and one single-head attention block
(its softmax in f32).  GroupNorm eps 1e-6.  Module names follow the
diffusers AutoencoderKL, so the weight bridge maps them mechanically.  The
decoder upsamples by nearest x2 + 3x3 conv.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.distributions import DiagonalGaussianDistribution


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 conv after a (0,1,0,1) pad on the right and bottom."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest x2 upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class AttentionBlock(nn.Module):
    """Single-head spatial self-attention over H*W tokens; softmax in f32."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.query(h), self.key(h), self.value(h)
        scores = torch.einsum("bic,bjc->bij", q, k) * (float(C) ** -0.5)
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        h = self.proj_attn(torch.einsum("bij,bjc->bic", probs, v))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-6):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(channels, channels, groups, eps),
                                      ResnetBlock2D(channels, channels, groups, eps)])
        self.attentions = nn.ModuleList([AttentionBlock(channels, groups, eps)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, groups: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels, groups)
            for j in range(num_layers))
        self.downsamplers = nn.ModuleList([Downsample2D(out_channels)] if add_downsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.resnets:
            x = m(x)
        for m in self.downsamplers:
            x = m(x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int, groups: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels, groups)
            for j in range(num_layers))
        self.upsamplers = nn.ModuleList([Upsample2D(out_channels)] if add_upsample else [])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.resnets:
            x = m(x)
        for m in self.upsamplers:
            x = m(x)
        return x


class Encoder(nn.Module):
    def __init__(self, in_channels: int, latent_channels: int, block_out_channels: Sequence[int],
                 layers_per_block: int, groups: int):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock2D(ch[max(i - 1, 0)], ch[i], layers_per_block, groups,
                               add_downsample=i < len(ch) - 1)
            for i in range(len(ch)))
        self.mid_block = UNetMidBlock2D(ch[-1], groups)
        self.conv_norm_out = nn.GroupNorm(groups, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for blk in self.down_blocks:
            x = blk(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, latent_channels: int, out_channels: int,
                 block_out_channels: Sequence[int], layers_per_block: int, groups: int):
        super().__init__()
        rev = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, rev[0], 3, padding=1)
        self.mid_block = UNetMidBlock2D(rev[0], groups)
        self.up_blocks = nn.ModuleList(
            UpDecoderBlock2D(rev[max(i - 1, 0)], rev[i], layers_per_block + 1, groups,
                             add_upsample=i < len(rev) - 1)
            for i in range(len(rev)))
        self.conv_norm_out = nn.GroupNorm(groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor, return_features: bool = False):
        """With ``return_features`` also the features before ``conv_out``
        (what the GAN's adaptive weight differentiates through)."""
        x = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            x = blk(x)
        x = F.silu(self.conv_norm_out(x))
        out = self.conv_out(x)
        return (out, x) if return_features else out


class FirstStageEncoder(nn.Module):
    """The modules of :meth:`AutoencoderKL.encode_moments` (shared, not
    copied), under the names they have in the VAE: what an encode in another
    dtype casts."""

    def __init__(self, vae: "AutoencoderKL"):
        super().__init__()
        self.encoder = vae.encoder
        self.quant_conv = vae.quant_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return AutoencoderKL.encode_moments(self, x)


class FeatureDecoder(nn.Module):
    """The modules of :meth:`AutoencoderKL.decode_with_features` (shared,
    not copied), under the names they have in the VAE."""

    def __init__(self, vae: "AutoencoderKL"):
        super().__init__()
        self.decoder = vae.decoder
        self.post_quant_conv = vae.post_quant_conv

    def forward(self, z: torch.Tensor):
        return AutoencoderKL.decode_with_features(self, z)


class AutoencoderKL(nn.Module):
    # seeded initialisation: flax's defaults (lecun_normal), as the JAX VAE's nn.Conv / nn.Dense
    FLAX_DEFAULT_INIT = True

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 64, norm_num_groups: int = 32):
        super().__init__()
        self.encoder = Encoder(in_channels, latent_channels, block_out_channels,
                               layers_per_block, norm_num_groups)
        self.decoder = Decoder(latent_channels, out_channels, block_out_channels,
                               layers_per_block, norm_num_groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) frames -> (n, h, w, 2c) posterior moments (mean | logvar)."""
        return self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """(n, H, W, C) frames -> the posterior over (n, h, w, c) latents."""
        return DiagonalGaussianDistribution.from_parameters(self.encode_moments(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(n, h, w, c) latents -> (n, H, W, C) frames."""
        return self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)

    def decode_with_features(self, z: torch.Tensor):
        """(n, h, w, c) latents -> the (n, H, W, C) frames and the NHWC
        features before the decoder's ``conv_out``."""
        out, feats = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)),
                                  return_features=True)
        return out.permute(0, 2, 3, 1), feats.permute(0, 2, 3, 1)

    def forward(self, sample: torch.Tensor, sample_posterior: bool = False,
                generator: Optional[torch.Generator] = None):
        """Encode, take the posterior's sample (from ``generator``) or mode,
        decode: ``(reconstruction, posterior)``."""
        posterior = self.encode(sample)
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        return self.decode(z), posterior
