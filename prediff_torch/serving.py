"""Serving API: build the pipeline once, produce forecasts.

>>> predictor = PreDiffPredictor()                 # seeded weights, on the card
>>> forecast = predictor.predict(context)         # (B, 6, 128, 128, 1)
"""
from typing import Dict, Optional, Union

import numpy as np
import torch

from .config import ConfigDict, prediff_default_config
from .factory import build_pipeline


class PreDiffPredictor:
    """Unguided SEVIR-LR nowcaster on one device."""

    def __init__(self, cfg: Optional[ConfigDict] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 device=None, seed: int = 0):
        self.cfg = cfg or prediff_default_config()
        self.ld = build_pipeline(self.cfg, with_alignment=False, device=device, params=params,
                                 seed=seed)
        self.device = self.ld.device

    def predict(self, context: Union[np.ndarray, torch.Tensor], timesteps: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One forecast per context: (B, T_in, H, W, C) -> (B, T_out, H, W, C)."""
        y = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        return self.ld.sample(y, timesteps=timesteps, generator=generator)
