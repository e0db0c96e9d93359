"""SEVIR / SEVIR-LR data pipeline: host-side numpy over h5py + pandas.

The port's own copy of ``prediff_tpu/datasets/sevir.py`` (reference
SEVIRDataLoader, src/prediff/datasets/sevir/sevir_dataloader.py:87;
SEVIRTorchDataset / SEVIRLightningDataModule, sevir_torch_wrap.py:72,162):
the same catalog, windows, sharding, preprocessing and batches for the same
seed.  ``SEVIRDataset`` is a ``torch.utils.data.Dataset``.  Catalog-driven
event loading over HDF5 files; each raw event (25 frames in SEVIR-LR, 49 in
SEVIR) splits into windows of ``seq_len`` with ``stride``; manual sharding
(num_shard/rank/split_mode) supports multi-process input (ref :107-155,
329-358).  VIL is rescaled to [0, 1] ('01') or with the original offsets
('sevir').  Output layout defaults to NTHWC.  h5py and pandas are imported
only if present; the loader needs both.  Not ported: the download branch of
``prepare_data`` (it needs the network).
"""
import datetime
import os
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch.utils.data

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

try:
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None


SEVIR_DATA_TYPES = ["vis", "ir069", "ir107", "vil", "lght"]
SEVIR_RAW_DTYPES = {
    "vis": np.int16, "ir069": np.int16, "ir107": np.int16,
    "vil": np.uint8, "lght": np.int16,
}
LIGHTING_FRAME_TIMES = np.arange(-120.0, 125.0, 5) * 60
SEVIR_DATA_SHAPE = {"lght": (48, 48)}
PREPROCESS_SCALE_SEVIR = {
    "vis": 1, "ir069": 1 / 1174.68, "ir107": 1 / 2562.43,
    "vil": 1 / 47.54, "lght": 1 / 0.60517,
}
PREPROCESS_OFFSET_SEVIR = {
    "vis": 0, "ir069": 3683.58, "ir107": 1552.80, "vil": -33.44, "lght": -0.02990,
}
PREPROCESS_SCALE_01 = {"vis": 1, "ir069": 1, "ir107": 1, "vil": 1 / 255, "lght": 1}
PREPROCESS_OFFSET_01 = {"vis": 0, "ir069": 0, "ir107": 0, "vil": 0, "lght": 0}

SEVIR_RAW_SEQ_LEN = 49
SEVIR_LR_RAW_SEQ_LEN = 25

_LAYOUT_FROM_NHWT = {
    # raw storage layout is NHWT (C=1 squeezed in)
    "NHWT": (0, 1, 2, 3),
    "NTHW": (0, 3, 1, 2),
    "TNHW": (3, 0, 1, 2),
}


def rasterize_lightning(
    strikes: np.ndarray,
    grid_hw: Sequence[int] = (48, 48),
    frame_times: np.ndarray = LIGHTING_FRAME_TIMES,
) -> np.ndarray:
    """Rasterize SEVIR's sparse lightning-event table to per-frame counts.

    SEVIR stores ``lght`` as an (N, 5) table of individual strikes —
    column 0 is the strike time in seconds relative to the event window,
    columns 3/4 are integer pixel coordinates on a 48x48 grid.  The dense
    representation is simply a 3-D histogram: pixel bins are the integer grid,
    frame bins are ``frame_times`` (left edges, 5-minute spacing).

    Semantics match the reference (sevir_dataloader.py:391-431): strikes
    outside the grid are dropped, strikes before the first frame time are
    counted into frame 0, strikes at/after the last frame time into the last
    frame.  Returns (H, W, T) int16 counts.
    """
    H, W = grid_hw
    T = len(frame_times)
    grid = np.zeros((H, W, T), np.int16)
    strikes = np.asarray(strikes)
    if strikes.size == 0:
        return grid
    x = strikes[:, 3].astype(np.int64)
    y = strikes[:, 4].astype(np.int64)
    in_grid = (x >= 0) & (x < H) & (y >= 0) & (y < W)
    x, y = x[in_grid], y[in_grid]
    # frame index: rightmost bin whose left edge is <= t, clamped into range
    t_bin = np.searchsorted(frame_times, strikes[in_grid, 0], side="right") - 1
    t_bin = np.clip(t_bin, 0, T - 1)
    np.add.at(grid, (y, x, t_bin), 1)
    return grid


def change_layout(data: np.ndarray, in_layout: str = "NHWT",
                  out_layout: str = "NHWT") -> np.ndarray:
    """Permute between layouts; 'C' denotes a singleton channel axis."""
    src = in_layout.replace("C", "")
    dst = out_layout.replace("C", "")
    perm = [src.index(a) for a in dst]
    data = np.transpose(data, perm)
    if "C" in out_layout:
        data = np.expand_dims(data, axis=out_layout.index("C"))
    return data


def max_pool_downsample(data: np.ndarray, factors, layout: str = "NHWT") -> np.ndarray:
    """Max-pool (t, h, w) by integer factors — runtime downsampling
    (ref :703-745 uses torch avg_pool2d for h/w + strided t; SEVIR-LR official
    downsampling uses block max, downsample_sevir.py)."""
    t_axis = layout.find("T")
    h_axis = layout.find("H")
    w_axis = layout.find("W")
    tf, hf, wf = factors
    slicer = [slice(None)] * data.ndim
    slicer[t_axis] = slice(None, None, tf)
    data = data[tuple(slicer)]
    # block-reduce h and w
    for axis, f in ((h_axis, hf), (w_axis, wf)):
        if f == 1:
            continue
        n = data.shape[axis] // f
        data = np.take(data, np.arange(n * f), axis=axis)
        new_shape = list(data.shape)
        new_shape[axis:axis + 1] = [n, f]
        data = data.reshape(new_shape).max(axis=axis + 1)
    return data


class SEVIRDataLoader:
    """Catalog-driven sharded loader over SEVIR HDF5 files."""

    def __init__(
        self,
        data_types: Optional[Sequence[str]] = None,
        seq_len: int = 49,
        raw_seq_len: int = 49,
        sample_mode: str = "sequent",
        stride: int = 12,
        batch_size: int = 1,
        layout: str = "NHWT",
        num_shard: int = 1,
        rank: int = 0,
        split_mode: str = "uneven",
        sevir_catalog: Union[str, "pd.DataFrame", None] = None,
        sevir_data_dir: Optional[str] = None,
        start_date: Optional[datetime.datetime] = None,
        end_date: Optional[datetime.datetime] = None,
        datetime_filter: Optional[Callable] = None,
        catalog_filter: Union[str, Callable, None] = "default",
        shuffle: bool = False,
        shuffle_seed: int = 1,
        output_type=np.float32,
        preprocess: bool = True,
        rescale_method: str = "01",
        downsample_dict: Optional[Dict[str, Sequence[int]]] = None,
        verbose: bool = False,
    ):
        if h5py is None or pd is None:
            raise ImportError("SEVIRDataLoader needs h5py and pandas")
        data_types = list(data_types or ["vil"])
        if not set(data_types).issubset(SEVIR_DATA_TYPES):
            raise ValueError(f"data_types {data_types} not in {SEVIR_DATA_TYPES}")
        if seq_len > raw_seq_len:
            raise ValueError(f"seq_len {seq_len} > raw_seq_len {raw_seq_len}")
        if sample_mode not in ("random", "sequent"):
            raise ValueError(f"sample_mode '{sample_mode}'")
        if split_mode not in ("ceil", "floor", "uneven"):
            raise ValueError(f"split_mode '{split_mode}'")
        if not (layout.replace("C", "") in ("NHWT", "NTHW", "TNHW") or layout in (
                "NTHWC", "NTCHW", "TNCHW", "NHWT")):
            raise ValueError(f"layout '{layout}'")
        self.data_types = data_types
        self.seq_len = seq_len
        self.raw_seq_len = raw_seq_len
        self.sample_mode = sample_mode
        self.stride = stride
        self.batch_size = batch_size
        self.layout = layout
        self.num_shard = num_shard
        self.rank = rank
        self.split_mode = split_mode
        self.lght_frame_times = LIGHTING_FRAME_TIMES
        self.data_shape = SEVIR_DATA_SHAPE
        self.output_type = output_type
        self.preprocess = preprocess
        self.rescale_method = rescale_method
        self.downsample_dict = downsample_dict
        self.shuffle = shuffle
        self.shuffle_seed = int(shuffle_seed)
        self.verbose = verbose

        if isinstance(sevir_catalog, str):
            self.catalog = pd.read_csv(sevir_catalog, parse_dates=["time_utc"],
                                       low_memory=False)
        else:
            self.catalog = sevir_catalog
        self.sevir_data_dir = sevir_data_dir

        if start_date is not None:
            self.catalog = self.catalog[self.catalog.time_utc > start_date]
        if end_date is not None:
            self.catalog = self.catalog[self.catalog.time_utc <= end_date]
        if datetime_filter is not None:
            self.catalog = self.catalog[datetime_filter(self.catalog.time_utc)]
        if catalog_filter is not None:
            if catalog_filter == "default":
                catalog_filter = lambda c: c.pct_missing == 0  # noqa: E731
            self.catalog = self.catalog[catalog_filter(self.catalog)]

        self._hdf_files: Dict[str, "h5py.File"] = {}
        self._samples = None
        self._compute_samples()
        self._open_files(verbose=verbose)
        self.reset()

    # ------------------------------------------------------------ #
    def _compute_samples(self):
        """Build the event table: one row per usable event id, with columns
        ``{type}_filename`` / ``{type}_index`` for each requested data type.

        An event is usable when every requested ``img_type`` appears exactly
        once among its catalog rows.  Formulated as a crosstab eligibility
        check followed by two pivots (the reference derives the same table
        through a groupby/filter/apply chain, sevir_dataloader.py:256-299;
        output rows are id-sorted in both formulations).
        """
        types = list(self.data_types)
        rows = self.catalog[self.catalog.img_type.isin(types)]
        counts = pd.crosstab(rows["id"], rows["img_type"])
        usable = counts.index[
            (counts.reindex(columns=types, fill_value=0) == 1).all(axis=1)
        ]
        rows = rows[rows["id"].isin(usable)]
        names = rows.pivot(index="id", columns="img_type", values="file_name")
        file_idx = rows.pivot(index="id", columns="img_type", values="file_index")
        table = {}
        for t in types:
            table[f"{t}_filename"] = names[t]
            # Lightning events are keyed by event id inside their HDF5 file;
            # raster types by integer dataset row (see _read_event).
            table[f"{t}_index"] = (
                names.index.to_series() if t == "lght" else file_idx[t]
            )
        self._samples = pd.DataFrame(table)
        if self.shuffle:
            self.shuffle_samples()

    def shuffle_samples(self):
        # pandas .sample keeps draw-for-draw parity with the reference's
        # seeded epoch shuffle (sevir_dataloader.py:301-307).
        self._samples = self._samples.sample(frac=1, random_state=self.shuffle_seed)

    def _open_files(self, verbose=False):
        names = sorted(
            {n for t in self.data_types for n in self._samples[f"{t}_filename"]}
        )
        self._hdf_files = {}
        for name in names:
            if verbose:
                print("Opening HDF5 file for reading", name)
            self._hdf_files[name] = h5py.File(
                os.path.join(self.sevir_data_dir, name), "r"
            )

    def close(self):
        while self._hdf_files:
            self._hdf_files.popitem()[1].close()

    # ------------------------------------------------------------ #
    @property
    def num_seq_per_event(self) -> int:
        return 1 + (self.raw_seq_len - self.seq_len) // self.stride

    @property
    def total_num_seq(self) -> int:
        return int(self.num_seq_per_event * self.num_event)

    @property
    def total_num_event(self) -> int:
        return int(self._samples.shape[0])

    @property
    def start_event_idx(self) -> int:
        return self.total_num_event // self.num_shard * self.rank

    @property
    def end_event_idx(self) -> int:
        if self.split_mode == "ceil":
            last_start = self.total_num_event // self.num_shard * (self.num_shard - 1)
            return self.start_event_idx + (self.total_num_event - last_start)
        if self.split_mode == "floor":
            return self.total_num_event // self.num_shard * (self.rank + 1)
        if self.rank == self.num_shard - 1:
            return self.total_num_event
        return self.total_num_event // self.num_shard * (self.rank + 1)

    @property
    def num_event(self) -> int:
        return self.end_event_idx - self.start_event_idx

    def __len__(self) -> int:
        """Number of batches per epoch in this shard."""
        return self.total_num_seq // self.batch_size

    # ------------------------------------------------------------ #
    def _read_event(self, row) -> Dict[str, np.ndarray]:
        """Read one catalog event: {data_type: (H, W, T) array}.

        Raster types are a single-index read from the per-type HDF5 dataset;
        lightning is rasterized from its sparse strike table (behavior pinned
        by tests/test_datasets.py golden tests; ref sevir_dataloader.py:360-431).
        """
        out = {}
        for typ in self.data_types:
            h5 = self._hdf_files[row[f"{typ}_filename"]]
            key = row[f"{typ}_index"]
            if typ == "lght":
                out[typ] = rasterize_lightning(
                    h5[key][:], self.data_shape["lght"], self.lght_frame_times
                )
            else:
                out[typ] = h5[typ][key]
        return out

    def _load_event_batch(self, event_idx: int, event_batch_size: int):
        """Stack ``event_batch_size`` consecutive events starting at
        ``event_idx`` into one (B, H, W, T) array per data type.  Indices past
        the shard end are zero-padded so batch shapes stay static
        (ref :541-607)."""
        stop = min(event_idx + event_batch_size, self.end_event_idx)
        assert stop > event_idx, (event_idx, self.end_event_idx)
        events = [
            self._read_event(self._samples.iloc[i])
            for i in range(event_idx, stop)
        ]
        n_pad = event_idx + event_batch_size - stop
        batch = []
        for typ in self.data_types:
            arr = np.stack([ev[typ] for ev in events]).astype(self.output_type)
            if n_pad:
                arr = np.concatenate(
                    [arr, np.zeros((n_pad,) + arr.shape[1:], self.output_type)]
                )
            batch.append(arr)
        return batch

    # ------------------------------------------------------------ #
    @staticmethod
    def preprocess_data_dict(data_dict, data_types=None, layout="NHWT", rescale="01"):
        if rescale == "sevir":
            scale_dict, offset_dict = PREPROCESS_SCALE_SEVIR, PREPROCESS_OFFSET_SEVIR
        elif rescale == "01":
            scale_dict, offset_dict = PREPROCESS_SCALE_01, PREPROCESS_OFFSET_01
        else:
            raise ValueError(f"Invalid rescale option: {rescale}.")
        if data_types is None:
            data_types = list(data_dict.keys())
        for key, data in data_dict.items():
            if key in data_types:
                data = data.astype(np.float32)
                data = change_layout(
                    scale_dict[key] * (data + offset_dict[key]),
                    in_layout="NHWT", out_layout=layout,
                )
                data_dict[key] = data
        return data_dict

    @staticmethod
    def process_data_dict_back(data_dict, data_types=None, rescale="01"):
        if rescale == "sevir":
            scale_dict, offset_dict = PREPROCESS_SCALE_SEVIR, PREPROCESS_OFFSET_SEVIR
        elif rescale == "01":
            scale_dict, offset_dict = PREPROCESS_SCALE_01, PREPROCESS_OFFSET_01
        else:
            raise ValueError(f"Invalid rescale option: {rescale}.")
        if data_types is None:
            data_types = list(data_dict.keys())
        for key in data_types:
            data_dict[key] = data_dict[key] / scale_dict[key] - offset_dict[key]
        return data_dict

    def downsample_data_dict(self, data_dict, data_types=None, factors_dict=None,
                             layout="NHWT"):
        if factors_dict is None:
            return data_dict
        if data_types is None:
            data_types = list(data_dict.keys())
        for key in data_types:
            if key in factors_dict:
                data_dict[key] = max_pool_downsample(
                    data_dict[key], factors_dict[key], layout=layout
                )
        return data_dict

    # ------------------------------------------------------------ #
    def reset(self, shuffle: Optional[bool] = None):
        self._curr_event_idx = self.start_event_idx
        self._curr_seq_idx = 0
        shuffle = self.shuffle if shuffle is None else shuffle
        if shuffle:
            self.shuffle_samples()
        self._rng = np.random.default_rng(self.shuffle_seed + self.rank)

    def __iter__(self):
        self.reset(shuffle=self.shuffle)
        if self.sample_mode == "random":
            for _ in range(len(self)):
                yield self._random_sample()
        else:
            for i in range(len(self)):
                yield self._idx_sample(
                    i + self.start_event_idx * self.num_seq_per_event
                    // self.batch_size
                )

    def _random_sample(self):
        """One random batch (ref :747-780)."""
        ret_dict = {}
        for _ in range(self.batch_size):
            event_idx = self._rng.integers(self.start_event_idx, self.end_event_idx)
            seq_start = self._rng.integers(0, self.raw_seq_len - self.seq_len + 1)
            event = self._load_event_batch(event_idx, 1)
            for imgt_idx, imgt in enumerate(self.data_types):
                seq = event[imgt_idx][:, :, :, seq_start:seq_start + self.seq_len]
                ret_dict[imgt] = (
                    np.concatenate((ret_dict[imgt], seq), axis=0)
                    if imgt in ret_dict else seq
                )
        return self._finalize(ret_dict)

    def _idx_sample(self, index: int):
        """Batch by global window index (map-style access, ref :834-891)."""
        event_idx = (index * self.batch_size) // self.num_seq_per_event
        seq_idx = (index * self.batch_size) % self.num_seq_per_event
        sampled = []
        for _ in range(self.batch_size):
            sampled.append((event_idx, seq_idx))
            seq_idx += 1
            if seq_idx >= self.num_seq_per_event:
                event_idx += 1
                seq_idx = 0
        start_event_idx = sampled[0][0]
        event_batch_size = sampled[-1][0] - start_event_idx + 1
        event_batch = self._load_event_batch(start_event_idx, event_batch_size)
        ret_dict = {}
        for ev, sq in sampled:
            batch_slice = [ev - start_event_idx]
            seq_slice = slice(sq * self.stride, sq * self.stride + self.seq_len)
            for imgt_idx, imgt in enumerate(self.data_types):
                seq = event_batch[imgt_idx][batch_slice, :, :, seq_slice]
                ret_dict[imgt] = (
                    np.concatenate((ret_dict[imgt], seq), axis=0)
                    if imgt in ret_dict else seq
                )
        return self._finalize(ret_dict)

    def _finalize(self, ret_dict):
        if self.preprocess:
            ret_dict = self.preprocess_data_dict(
                ret_dict, data_types=self.data_types, layout=self.layout,
                rescale=self.rescale_method,
            )
        if self.downsample_dict is not None:
            ret_dict = self.downsample_data_dict(
                ret_dict, data_types=self.data_types,
                factors_dict=self.downsample_dict, layout=self.layout,
            )
        return ret_dict

    def save_downsampled_dataset(self, save_dir: str,
                                 downsample_dict: Dict[str, Sequence[int]],
                                 verbose=True):
        """Offline SEVIR -> SEVIR-LR writer (block-max over t/h/w factors;
        ref :433-476, scripts/datasets/sevir/downsample_sevir.py)."""
        if os.path.exists(save_dir):
            raise FileExistsError(f"save_dir {save_dir} exists")
        os.makedirs(save_dir)
        for fname, hdf_file in self._hdf_files.items():
            data_type = fname.replace("\\", "/").split("/")[0]
            if data_type == "lght":
                raise NotImplementedError("lght downsampling not supported")
            if verbose:
                print(f"Downsampling data in {fname}.")
            data_i = hdf_file[data_type]
            tf = downsample_dict[data_type][0]
            data_i = data_i[:, :, :, ::tf]
            hf_, wf_ = downsample_dict[data_type][1:]
            N, H, W, T = data_i.shape
            data_i = (
                data_i[:, : H // hf_ * hf_, : W // wf_ * wf_, :]
                .reshape(N, H // hf_, hf_, W // wf_ * wf_, T)
                .max(axis=2)
                .reshape(N, H // hf_, W // wf_, wf_, T)
                .max(axis=3)
            )
            new_file_path = os.path.join(save_dir, fname)
            os.makedirs(os.path.dirname(new_file_path), exist_ok=True)
            with h5py.File(new_file_path, "w") as hf:
                hf.create_dataset(data_type, data=data_i,
                                  maxshape=(None, *data_i.shape[1:]))


class SEVIRDataset(torch.utils.data.Dataset):
    """Map-style dataset of single sequences (vil only), with augmentation;
    items are numpy arrays in the loader's layout without N.

    Parity: SEVIRTorchDataset (sevir_torch_wrap.py:72).  aug_mode:
      "0" none; "1" flips + free-angle rotation; "2" flips + 90-degree rots.
    """

    def __init__(self, sevir_dataloader: SEVIRDataLoader, seed: int = 0,
                 aug_mode: str = "0", ret_contiguous: bool = True):
        self.loader = sevir_dataloader
        self.aug_mode = aug_mode
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.loader.total_num_seq // self.loader.batch_size

    def __getitem__(self, index: int) -> np.ndarray:
        from .augmentation import augment_seq

        data_dict = self.loader._idx_sample(index=index)
        data = data_dict["vil"].squeeze(0)  # layout without N
        if self.aug_mode != "0":
            data = augment_seq(data, self.loader.layout.replace("N", ""),
                               self.aug_mode, self.rng)
        return data


class SEVIRDataModule:
    """Train/val/test split by dates + val_ratio (parity:
    SEVIRLightningDataModule, sevir_torch_wrap.py:162) producing batched
    numpy arrays (``datasets.prefetch.prefetch_to_device`` puts them on the
    card)."""

    def __init__(
        self,
        seq_len: int = 13,
        sample_mode: str = "sequent",
        stride: int = 6,
        layout: str = "NTHWC",
        output_type=np.float32,
        preprocess: bool = True,
        rescale_method: str = "01",
        verbose: bool = False,
        aug_mode: str = "0",
        dataset_name: str = "sevirlr",
        sevir_dir: Optional[str] = None,
        start_date=None,
        train_test_split_date=(2019, 6, 1),
        end_date=None,
        val_ratio: float = 0.1,
        batch_size: int = 1,
        seed: int = 0,
        num_shard: int = 1,
        rank: int = 0,
    ):
        self.dataset_name = dataset_name
        self.sevir_dir = sevir_dir
        if dataset_name == "sevir":
            self.raw_seq_len = SEVIR_RAW_SEQ_LEN
        elif dataset_name == "sevirlr":
            self.raw_seq_len = SEVIR_LR_RAW_SEQ_LEN
        else:
            raise ValueError(f"unknown dataset '{dataset_name}'")
        if sevir_dir is None:
            raise ValueError(
                "sevir_dir is required: pass --sevir-dir /path/to/sevirlr "
                "(expects CATALOG.csv + data/), or --synthetic to generate "
                "a synthetic dataset"
            )
        self.catalog_path = os.path.join(sevir_dir, "CATALOG.csv")
        self.data_dir = os.path.join(sevir_dir, "data")
        self.seq_len = seq_len
        self.sample_mode = sample_mode
        self.stride = stride
        self.layout = layout
        self.output_type = output_type
        self.preprocess = preprocess
        self.rescale_method = rescale_method
        self.verbose = verbose
        self.aug_mode = aug_mode
        self.batch_size = batch_size
        self.seed = seed
        self.num_shard = num_shard
        self.rank = rank
        self.start_date = (
            datetime.datetime(*start_date) if start_date is not None else None
        )
        self.train_test_split_date = (
            datetime.datetime(*train_test_split_date)
            if train_test_split_date is not None else None
        )
        self.end_date = datetime.datetime(*end_date) if end_date is not None else None
        self.val_ratio = val_ratio
        self._train = self._val = self._test = None

    def prepare_data(self):
        """Check that the dataset is in place (the reference's prepare_data,
        sevir_torch_wrap.py:240-251, without its download)."""
        if not os.path.exists(self.catalog_path):
            raise FileNotFoundError(
                f"{self.catalog_path} not found: place the {self.dataset_name} dataset there "
                "(CATALOG.csv + data/)")

    def _make_loader(self, start, end, shuffle: bool) -> SEVIRDataLoader:
        return SEVIRDataLoader(
            data_types=["vil"],
            seq_len=self.seq_len,
            raw_seq_len=self.raw_seq_len,
            sample_mode=self.sample_mode,
            stride=self.stride,
            batch_size=1,
            layout="NTHWC",
            num_shard=self.num_shard,
            rank=self.rank,
            sevir_catalog=self.catalog_path,
            sevir_data_dir=self.data_dir,
            start_date=start,
            end_date=end,
            shuffle=shuffle,
            shuffle_seed=self.seed,
            output_type=self.output_type,
            preprocess=self.preprocess,
            rescale_method=self.rescale_method,
            verbose=self.verbose,
        )

    def setup(self):
        trainval = self._make_loader(self.start_date, self.train_test_split_date, False)
        self._test = self._make_loader(self.train_test_split_date, self.end_date, False)
        # date-bounded train pool split into train/val by window index
        n = len(trainval)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        n_val = int(n * self.val_ratio)
        self._trainval = trainval
        self._val_indices = np.sort(perm[:n_val])
        self._train_indices = np.sort(perm[n_val:])

    @property
    def num_train_samples(self):
        return len(self._train_indices)

    @property
    def num_val_samples(self):
        return len(self._val_indices)

    @property
    def num_test_samples(self):
        return len(self._test)

    def _iter_batches(self, loader, indices, shuffle, aug, seed):
        rng = np.random.default_rng(seed)
        ds = SEVIRDataset(loader, seed=seed, aug_mode=aug if aug else "0")
        order = rng.permutation(len(indices)) if shuffle else np.arange(len(indices))
        batch = []
        for j in order:
            batch.append(ds[int(indices[j])])
            if len(batch) == self.batch_size:
                yield np.stack(batch, axis=0)
                batch = []
        # drop_last=False for eval parity: emit the remainder
        if batch and not shuffle:
            yield np.stack(batch, axis=0)

    def train_batches(self, epoch_seed: int = 0):
        yield from self._iter_batches(
            self._trainval, self._train_indices, True, self.aug_mode,
            self.seed + epoch_seed,
        )

    def train_latent_batches(self, cache, epoch_seed: int = 0):
        """Latent twin of :meth:`train_batches`: same window order and
        augmentation stream (rng-for-rng), but yields (moments, frame_mean)
        from a pre-encoded :class:`~prediff_torch.datasets.latents.LatentCache`
        instead of pixels — see datasets/latents.py."""
        from .latents import iter_latent_batches

        yield from iter_latent_batches(
            self._trainval, cache, self._train_indices, True, self.aug_mode,
            self.seed + epoch_seed, self.batch_size,
        )

    def val_batches(self):
        yield from self._iter_batches(self._trainval, self._val_indices, False,
                                      "0", self.seed)

    def test_batches(self):
        yield from self._iter_batches(
            self._test, np.arange(len(self._test)), False, "0", self.seed
        )
