"""Synthetic SEVIR-LR-like data: advected, pulsing Gaussian precipitation
cells, made with numpy from a seed.  The port's own copy of
``prediff_tpu/datasets/synthetic.py`` (the same seed gives the same arrays):
batches for training and benchmarking without any file, and the HDF5 +
``CATALOG.csv`` layout the real loader reads, so the whole data path
(catalog -> windows -> preprocessing -> sharding) runs without the SEVIR
archive.  h5py and pandas are imported only if present; the writer needs both."""
import datetime
import os
from typing import Iterator, Optional, Tuple

import numpy as np

try:
    import h5py
    import pandas as pd
except ImportError:  # pragma: no cover
    h5py = None
    pd = None


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


def make_synthetic_sevir_lr(root: str, num_events: int = 8, H: int = 128, W: int = 128,
                            T: int = 25, events_per_file: int = 4, seed: int = 0,
                            train_frac_after: Tuple[int, int, int] = (2019, 6, 1)) -> str:
    """Create ``root/CATALOG.csv`` + ``root/data/vil/2019/*.h5``; half the
    events are dated before the reference train/test split date, half after."""
    if h5py is None or pd is None:
        raise ImportError("make_synthetic_sevir_lr needs h5py and pandas")
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "data", "vil", "2019"), exist_ok=True)
    rows = []
    file_idx = 0
    ev = 0
    while ev < num_events:
        n = min(events_per_file, num_events - ev)
        fname = f"vil/2019/SEVIR_VIL_SYNTH_{file_idx:04d}.h5"
        arr = np.stack([_blob_event(rng, H, W, T) for _ in range(n)], axis=0)
        with h5py.File(os.path.join(root, "data", fname), "w") as hf:
            hf.create_dataset("vil", data=arr, maxshape=(None, H, W, T))
        for i in range(n):
            before = (ev + i) % 2 == 0
            date = (datetime.datetime(2019, 3, 1) if before else datetime.datetime(2019, 7, 1)
                    ) + datetime.timedelta(days=int(ev + i))
            rows.append(dict(id=f"S{ev + i:05d}", file_name=fname, file_index=i, img_type="vil",
                             time_utc=date, pct_missing=0.0))
        ev += n
        file_idx += 1
    pd.DataFrame(rows).to_csv(os.path.join(root, "CATALOG.csv"), index=False)
    return root


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
