"""SEVIR / SEVIR-LR data on the host (numpy over h5py + pandas, each imported
only if present), augmentation, synthetic data, the latent cache and the
pinned side-stream prefetch to the card (counterpart of
``prediff_tpu/datasets``)."""
from .sevir import (
    SEVIRDataLoader,
    SEVIRDataset,
    SEVIRDataModule,
    SEVIR_DATA_TYPES,
    PREPROCESS_SCALE_01,
    PREPROCESS_SCALE_SEVIR,
    PREPROCESS_OFFSET_SEVIR,
)
from .augmentation import augment_seq, fixed_angle_rotation
from .synthetic import make_synthetic_sevir_lr, synthetic_batch_iterator
from .prefetch import prefetch_to_device
