from .unet import CuboidTransformerUNet
from .vae import AutoencoderKL

__all__ = ["CuboidTransformerUNet", "AutoencoderKL"]
