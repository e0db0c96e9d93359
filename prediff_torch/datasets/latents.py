"""Latent pre-encoding cache: run the frozen VAE encoder over the dataset
ONCE, train the diffusion / alignment models from cached encoder moments
(``DiffusionTrainer(latent_inputs=True)``, ``AlignmentTrainer(latent_inputs=True)``).

The port's own copy of ``prediff_tpu/datasets/latents.py``; a cache written
by either package reads in the other.  The reference re-runs the frozen
first stage inside every training step (latent_diffusion.py:434 via
encode_first_stage, alignment_pl.py:350-373), all of it inference on weights
that never change; pre-encoding moves the whole encoder out of the step.  Because PreDiff v1's
augmentation mode "2" (flips + 90-degree rotations, sevir_torch_wrap.py:
127-142) generates exactly the dihedral group D4, caching the 8 variants'
moments preserves the training distribution EXACTLY — and with the same
seed, the latent run reproduces the pixel run's per-sample augmentation
choices draw-for-draw (see :func:`draw_d4_variant`).

What is cached per event (HDF5, see :func:`write_latent_cache`):
  - ``moments``    (N, V, T_raw, h, w, 2c): encoder mean||logvar of every
    preprocessed frame, per D4 variant (V=1 for aug "0", 8 for aug "2"),
    BEFORE ``scale_factor`` (applied at use, like encode_first_stage).
  - ``frame_mean`` (N, T_raw): per-frame mean of the preprocessed pixels —
    the knowledge-alignment regression target (avg_x_objective); it is
    D4-invariant so one copy serves every variant.
  - ``keys``       (N,): "vil_filename|vil_index" catalog identity, so a
    date-filtered training loader can map its events onto cache rows.

Free-angle rotation (aug mode "1") cannot be cached (the encoder is not
equivariant to arbitrary rotations); requesting it raises.  h5py is imported
where a cache is written or read, so the package imports without it.
"""
import json
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

D4_NUM_VARIANTS = 8


def event_key(samples_row) -> str:
    """Catalog identity of one event row of ``SEVIRDataLoader._samples``."""
    return f"{samples_row['vil_filename']}|{samples_row['vil_index']}"


def apply_d4(data: np.ndarray, variant: int, h_axis: int, w_axis: int) -> np.ndarray:
    """Apply D4 element ``variant = m*4 + j``: flip H ``m`` times, then
    rotate 90° CCW ``j`` times (numpy rot90 over (h_axis, w_axis) — the same
    convention as augmentation.fixed_angle_rotation for multiples of 90)."""
    m, j = divmod(int(variant), 4)
    if m:
        data = np.flip(data, axis=h_axis)
    if j:
        data = np.rot90(data, k=j, axes=(h_axis, w_axis))
    return np.ascontiguousarray(data)


def draw_d4_variant(rng: np.random.Generator, aug_mode: str) -> int:
    """Draw the D4 variant for one sample, consuming ``rng`` EXACTLY like
    ``augmentation.augment_seq`` (flip-H uniform, flip-W uniform, rotation
    choice) so a latent-cache run reproduces the pixel run's augmentation
    stream given the same seed.  The (fh, fw, k) -> group-element map is
    m = fh xor fw, j = (k + 2*fw) mod 4 (verified exhaustively in tests)."""
    if aug_mode == "0":
        return 0
    if aug_mode != "2":
        raise NotImplementedError(
            f"latent cache supports aug modes '0' and '2'; free-angle mode "
            f"'{aug_mode}' cannot be pre-encoded"
        )
    fh = rng.random() < 0.5
    fw = rng.random() < 0.5
    k = int(rng.choice(np.asarray((0, 90, 180, 270)))) // 90
    return (int(fh) ^ int(fw)) * 4 + (k + 2 * int(fw)) % 4


def write_latent_cache(
    path: str,
    loader,
    encode_moments: Callable[[np.ndarray], np.ndarray],
    aug: str = "d4",
    moments_dtype: str = "float16",
    frame_batch: int = 32,
    verbose: bool = False,
    encode_dtype: Optional[str] = None,
) -> None:
    """Encode every event of ``loader`` (a SEVIRDataLoader over the FULL date
    range, vil only) into ``path``.

    ``encode_moments``: (n_frames, H, W, 1) preprocessed float32 numpy in
    [0,1] -> (n_frames, h, w, 2c) float32 moments, numpy or a tensor on any
    device; typically the VAE's ``encode_moments`` on the card (frames are
    padded to ``frame_batch``, so every call has one shape).
    """
    import h5py

    if loader.data_types != ["vil"]:
        raise ValueError("the latent cache covers vil datasets")
    n_variants = D4_NUM_VARIANTS if aug == "d4" else 1
    n_events = loader.total_num_event
    raw_t = loader.raw_seq_len

    def encode_padded(frames: np.ndarray) -> np.ndarray:
        outs = []
        for s in range(0, frames.shape[0], frame_batch):
            chunk = frames[s:s + frame_batch]
            n_pad = frame_batch - chunk.shape[0]
            if n_pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((n_pad,) + chunk.shape[1:], chunk.dtype)]
                )
            out = encode_moments(chunk)
            if isinstance(out, torch.Tensor):
                out = out.detach().cpu().numpy()
            out = np.asarray(out)
            outs.append(out[:frame_batch - n_pad] if n_pad else out)
        return np.concatenate(outs)

    first = None
    with h5py.File(path, "w") as f:
        keys = []
        for ev in range(n_events):
            # one event, preprocessed exactly like training batches
            # (scale to [0,1], NHWT layout -> (T, H, W, 1) frames)
            raw = loader._load_event_batch(ev, 1)[0]  # (1, H, W, T)
            d = loader.preprocess_data_dict(
                {"vil": raw}, data_types=["vil"], layout="NHWT",
                rescale=loader.rescale_method,
            )
            frames = np.transpose(d["vil"][0], (2, 0, 1))[..., None].astype(
                np.float32
            )  # (T, H, W, 1)
            for v in range(n_variants):
                fv = apply_d4(frames, v, h_axis=1, w_axis=2)
                mom = encode_padded(fv)
                if first is None:
                    first = mom.shape[1:]
                    f.create_dataset(
                        "moments", (n_events, n_variants, raw_t) + first,
                        dtype=moments_dtype,
                    )
                    f.create_dataset("frame_mean", (n_events, raw_t), dtype="f4")
                f["moments"][ev, v] = mom.astype(moments_dtype)
            f["frame_mean"][ev] = frames.mean(axis=(1, 2, 3))
            keys.append(event_key(loader._samples.iloc[ev]))
            if verbose and (ev % 50 == 0 or ev == n_events - 1):
                print(f"  encoded event {ev + 1}/{n_events}", flush=True)
        f.create_dataset(
            "keys", data=np.asarray(keys, dtype=h5py.string_dtype())
        )
        f.attrs["meta"] = json.dumps(dict(
            n_variants=n_variants, raw_seq_len=raw_t,
            rescale_method=loader.rescale_method,
            moments_dtype=moments_dtype, aug=aug,
            # the encoder COMPUTE dtype used when writing (the pixel path's
            # exactness holds only when its encode dtype matches: a
            # bf16-written cache and an f32 pixel step differ by one
            # encode's rounding)
            encode_dtype=encode_dtype or "unspecified",
        ))


class LatentCache:
    """Reader over a :func:`write_latent_cache` file."""

    def __init__(self, path: str):
        import h5py

        if not os.path.exists(path):
            raise FileNotFoundError(f"latent cache not found: {path}")
        self.path = path
        self._f = h5py.File(path, "r")
        self.meta = json.loads(self._f.attrs["meta"])
        self.n_variants = int(self.meta["n_variants"])
        self.raw_seq_len = int(self.meta["raw_seq_len"])
        keys = [k.decode() if isinstance(k, bytes) else str(k)
                for k in self._f["keys"][:]]
        self._row = {k: i for i, k in enumerate(keys)}

    def close(self):
        self._f.close()

    def row_for(self, key: str) -> int:
        try:
            return self._row[key]
        except KeyError:
            raise KeyError(
                f"event {key!r} missing from latent cache {self.path}; "
                f"write the cache again (write_latent_cache) over the full catalog"
            ) from None

    def read_window(self, row: int, variant: int, t0: int, seq_len: int):
        """-> (moments (T,h,w,2c) f32, frame_mean (T,) f32)."""
        mom = self._f["moments"][row, variant, t0:t0 + seq_len].astype(
            np.float32
        )
        fm = self._f["frame_mean"][row, t0:t0 + seq_len].astype(np.float32)
        return mom, fm


class LatentSEVIRDataset:
    """Map-style latent twin of ``SEVIRDataset``: same window-index space as
    its ``SEVIRDataLoader`` (batch_size 1), but returns cached moments (+
    per-frame pixel means) instead of pixels, applying augmentation by
    variant selection.  With the same seed, sample i gets the same D4
    element the pixel dataset would have applied."""

    def __init__(self, sevir_dataloader, cache: LatentCache, seed: int = 0,
                 aug_mode: str = "0"):
        if aug_mode == "2" and cache.n_variants != D4_NUM_VARIANTS:
            raise ValueError(
                "aug mode '2' needs a cache written with --aug d4 "
                f"(this one has {cache.n_variants} variant(s))"
            )
        self.loader = sevir_dataloader
        self.cache = cache
        self.aug_mode = aug_mode
        self.rng = np.random.default_rng(seed)
        self._rows = [
            cache.row_for(event_key(sevir_dataloader._samples.iloc[i]))
            for i in range(sevir_dataloader.total_num_event)
        ]

    def __len__(self):
        return self.loader.total_num_seq

    def __getitem__(self, index: int):
        nspe = self.loader.num_seq_per_event
        event_idx, seq_idx = index // nspe, index % nspe
        variant = draw_d4_variant(self.rng, self.aug_mode)
        return self.cache.read_window(
            self._rows[event_idx], variant,
            seq_idx * self.loader.stride, self.loader.seq_len,
        )


def iter_latent_batches(
    loader, cache: LatentCache, indices, shuffle: bool, aug_mode: str,
    seed: int, batch_size: int,
) -> Iterator:
    """Latent twin of ``SEVIRDataModule._iter_batches``: identical rng usage
    (one permutation draw + per-sample aug draws in access order), so a
    latent epoch visits the same windows with the same augmentations as the
    pixel epoch it replaces.  Yields (moments (B,T,h,w,2c), frame_mean
    (B,T)) float32 batches."""
    rng = np.random.default_rng(seed)
    ds = LatentSEVIRDataset(loader, cache, seed=seed,
                            aug_mode=aug_mode if aug_mode else "0")
    order = rng.permutation(len(indices)) if shuffle else np.arange(len(indices))
    mom_batch, fm_batch = [], []
    for j in order:
        mom, fm = ds[int(indices[j])]
        mom_batch.append(mom)
        fm_batch.append(fm)
        if len(mom_batch) == batch_size:
            yield np.stack(mom_batch), np.stack(fm_batch)
            mom_batch, fm_batch = [], []
    if mom_batch and not shuffle:
        yield np.stack(mom_batch), np.stack(fm_batch)
