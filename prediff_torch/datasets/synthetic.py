"""Synthetic SEVIR-LR-like batches: advected, pulsing Gaussian precipitation
cells, made with numpy from a seed.  The port's own copy of the generator in
``prediff_tpu/datasets/synthetic.py`` (the same seed gives the same batches),
for training and benchmarking without any file."""
from typing import Iterator, Optional

import numpy as np


def _blob_event(rng: np.random.Generator, H: int, W: int, T: int) -> np.ndarray:
    """One event: a few advected, pulsing Gaussian cells, uint8 VIL (H, W, T)."""
    n_blobs = rng.integers(2, 5)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.zeros((H, W, T), dtype=np.float32)
    for _ in range(n_blobs):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        vx, vy = rng.uniform(-2, 2, size=2)
        sigma = rng.uniform(H / 16, H / 5)
        amp = rng.uniform(80, 255)
        phase = rng.uniform(0, 2 * np.pi)
        for t in range(T):
            cxt, cyt = cx + vx * t, cy + vy * t
            pulse = 0.75 + 0.25 * np.sin(phase + 0.4 * t)
            frames[:, :, t] += amp * pulse * np.exp(
                -(((xx - cxt) ** 2 + (yy - cyt) ** 2) / (2 * sigma**2)))
    return np.clip(frames, 0, 255).astype(np.uint8)


def synthetic_batch_iterator(batch_size: int = 2, seq_len: int = 13, H: int = 128, W: int = 128,
                             seed: int = 0,
                             num_batches: Optional[int] = None) -> Iterator[np.ndarray]:
    """Infinite (or bounded) iterator of (B, seq_len, H, W, 1) float32 batches in [0, 1]."""
    rng = np.random.default_rng(seed)
    i = 0
    while num_batches is None or i < num_batches:
        batch = np.stack([_blob_event(rng, H, W, seq_len).astype(np.float32) / 255.0
                          for _ in range(batch_size)], axis=0)  # (B, H, W, T)
        yield batch.transpose(0, 3, 1, 2)[..., None]  # (B, T, H, W, 1)
        i += 1
