"""Serving API: build the pipeline once, produce (ensemble) forecasts.

>>> predictor = PreDiffPredictor()                 # seeded weights, on the card
>>> predictor = PreDiffPredictor.from_npz("weights/")      # the JAX package's export
>>> predictor = PreDiffPredictor.from_torch("pretrained/")  # the reference's .pt files
>>> forecast = predictor.predict(context)         # (B, 6, 128, 128, 1)
>>> guided = predictor.predict(context, use_alignment=True, avg_x_gt=avg, ddim_steps=50)
>>> ens = predictor.predict_ensemble(context, num_samples=8)   # (8, B, 6, 128, 128, 1)
>>> fast = PreDiffPredictor(params=cast_to_bf16(params), compute_dtype="bfloat16")

A model takes its parameters' dtype (``utils.precision.cast_to_bf16`` of the
parameter tree, or a bf16 ``.npz``) and runs as flax promotes: the bf16 tree
on a bf16 carry is a bf16 network, on an f32 carry the f32 network on a copy
of the rounded weights (``diffusion/latent_diffusion.py``).

On the card every reverse step replays a captured CUDA graph, cached per
static key (``diffusion/graphs.py``); the first forecast of a key captures.

On several ranks (``torchrun --nproc_per_node=N``, or
``parallel.init_distributed``) ``mesh="auto"`` shards each forecast's batch,
ensemble members included, across the ranks: every rank calls ``predict``
with the same arguments and gets the whole output
(``diffusion/latent_diffusion.py``'s note on a mesh).
"""
import os
from typing import Dict, Optional, Union

import numpy as np
import torch

from .config import ConfigDict, prediff_default_config
from .factory import build_alignment_model, build_pipeline, build_unet, build_vae
from .parallel.mesh import DataMesh, make_mesh, process_count
from .utils.checkpoint import PRETRAINED_NAMES, load_flax_npz, load_torch_state_dict
from .utils.convert import flax_params_to_torch

# model -> (its factory function, the JAX package's .npz file, the reference's .pt file)
_FILES = {"unet": (build_unet, "earthformerunet.npz", PRETRAINED_NAMES["earthformerunet"]),
          "vae": (build_vae, "vae.npz", PRETRAINED_NAMES["vae"]),
          "align": (build_alignment_model, "alignment.npz", PRETRAINED_NAMES["alignment"])}


class PreDiffPredictor:
    """SEVIR-LR nowcaster, optionally steered by knowledge alignment toward
    an anticipated mean intensity.  ``compute_dtype`` is the chain's
    (``LatentDiffusion.sample``: float32, bfloat16 or float16); guidance
    takes its own from ``cfg.model.align.compute_dtype``.  ``mesh="auto"``:
    the ranks of a process group of more than one rank (``make_mesh()``),
    else one device; a ``DataMesh`` or None overrides it.  It never starts
    a group itself.  ``device`` defaults to the mesh's.  Every rank loads the
    weights itself (from disk, or the same seed): nothing is broadcast."""

    def __init__(self, cfg: Optional[ConfigDict] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 with_alignment: bool = True, device=None, seed: int = 0,
                 compute_dtype: str = "float32", mesh="auto"):
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh={mesh!r}: 'auto', a DataMesh or None")
            mesh = make_mesh() if process_count() > 1 else None
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a DataMesh, 'auto' or None, not {type(mesh)}")
        self.mesh = mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.cfg = cfg or prediff_default_config()
        self.with_alignment = with_alignment
        self.compute_dtype = compute_dtype
        self.ld = build_pipeline(self.cfg, with_alignment=with_alignment, device=device,
                                 params=params, seed=seed)
        self.device = self.ld.device

    @classmethod
    def from_npz(cls, weights_dir: str, cfg: Optional[ConfigDict] = None,
                 with_alignment: bool = True, **kw) -> "PreDiffPredictor":
        """Weights from the JAX package's ``.npz`` trees (``earthformerunet.npz``,
        ``vae.npz``, ``alignment.npz``; a model whose file is absent takes the
        seeded initialisation, as there)."""
        cfg = cfg or prediff_default_config()
        params = {}
        for key, (build, npz, _) in _FILES.items():
            path = os.path.join(weights_dir, npz)
            if os.path.exists(path) and (key != "align" or with_alignment):
                params[key] = flax_params_to_torch(build(cfg), load_flax_npz(path))
        return cls(cfg=cfg, params=params, with_alignment=with_alignment, **kw)

    @classmethod
    def from_torch(cls, pt_dir: str, cfg: Optional[ConfigDict] = None,
                   with_alignment: bool = True, **kw) -> "PreDiffPredictor":
        """Weights from the reference's ``.pt`` files (``PRETRAINED_NAMES``),
        plain or Lightning-wrapped; a key missing or left over raises."""
        cfg = cfg or prediff_default_config()
        keys = ("unet", "vae", "align") if with_alignment else ("unet", "vae")
        params = {key: load_torch_state_dict(os.path.join(pt_dir, _FILES[key][2]),
                                             _FILES[key][0](cfg)) for key in keys}
        return cls(cfg=cfg, params=params, with_alignment=with_alignment, **kw)

    def _sample_kwargs(self, use_alignment: bool, avg_x_gt, ddim_steps: Optional[int],
                       timesteps: Optional[int], guidance_every_k: int,
                       generator: Optional[torch.Generator]):
        kw = dict(timesteps=timesteps, generator=generator, compute_dtype=self.compute_dtype,
                  mesh=self.mesh)
        if ddim_steps:
            kw.update(sampler="ddim", ddim_steps=ddim_steps)
        if use_alignment:
            if not self.with_alignment or avg_x_gt is None:
                raise ValueError("use_alignment needs with_alignment=True and avg_x_gt")
            kw.update(use_alignment=True, guidance_every_k=guidance_every_k,
                      alignment_kwargs={"avg_x_gt": torch.as_tensor(avg_x_gt, dtype=torch.float32)})
        return kw

    def predict(self, context: Union[np.ndarray, torch.Tensor], use_alignment: bool = False,
                avg_x_gt: Optional[Union[np.ndarray, torch.Tensor]] = None,
                ddim_steps: Optional[int] = None, timesteps: Optional[int] = None,
                guidance_every_k: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One forecast per context: (B, T_in, H, W, C) -> (B, T_out, H, W, C).
        ``use_alignment`` steers toward ``avg_x_gt`` (anticipated mean
        intensity, (B, 1)); ``ddim_steps`` samples by DDIM instead of DDPM."""
        y = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        return self.ld.sample(y, **self._sample_kwargs(use_alignment, avg_x_gt, ddim_steps,
                                                       timesteps, guidance_every_k, generator))

    def predict_ensemble(self, context: Union[np.ndarray, torch.Tensor], num_samples: int = 8,
                         use_alignment: bool = False,
                         avg_x_gt: Optional[Union[np.ndarray, torch.Tensor]] = None,
                         ddim_steps: Optional[int] = None, timesteps: Optional[int] = None,
                         guidance_every_k: int = 1,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(num_samples, B, T_out, H, W, C): the members folded into the
        batch, across the mesh's ranks where there is one."""
        y = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        return self.ld.sample_ensemble(
            y, num_samples, **self._sample_kwargs(use_alignment, avg_x_gt, ddim_steps, timesteps,
                                                  guidance_every_k, generator))
