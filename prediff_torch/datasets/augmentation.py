"""Data augmentation (host-side numpy); the port's own copy of
``prediff_tpu/datasets/augmentation.py``, scipy imported only if present.

Reference parity: SEVIRTorchDataset aug modes (sevir_torch_wrap.py:127-142)
and TransformsFixRotation (datasets/augmentation.py:7):
  "0": none
  "1": random h/v flips + free-angle rotation
  "2": random h/v flips + multiples-of-90-degree rotation  (PreDiff v1 uses "2")
"""
from typing import Sequence

import numpy as np

try:
    from scipy.ndimage import rotate as _scipy_rotate
except ImportError:  # pragma: no cover
    _scipy_rotate = None


def fixed_angle_rotation(data: np.ndarray, angle: float, h_axis: int,
                         w_axis: int, order: int = 0) -> np.ndarray:
    """Rotate by an arbitrary angle (degrees, counter-clockwise in display
    coords) about the geometric image center, zeros fill.

    Numerical spec (matches torchvision's RandomRotation defaults used by the
    reference, sevir_torch_wrap.py:130-134): nearest interpolation (order=0),
    no expand, fill=0, rotation center = geometric center; direction and
    center conventions are pinned by the JAX package's impulse tests.
    Pass order=1 for bilinear."""
    if angle % 90 == 0:
        k = int(angle // 90) % 4
        return np.rot90(data, k=k, axes=(h_axis, w_axis)).copy()
    if _scipy_rotate is None:
        raise ImportError("free-angle rotation needs scipy")
    return _scipy_rotate(data, angle, axes=(h_axis, w_axis), reshape=False,
                         order=order, mode="constant", cval=0.0)


def augment_seq(data: np.ndarray, layout: str, aug_mode: str,
                rng: np.random.Generator,
                rotation_angles: Sequence[float] = (0, 90, 180, 270)) -> np.ndarray:
    """Apply flips/rotation to a single sequence whose layout (without N)
    contains 'H' and 'W'."""
    if aug_mode == "0":
        return data
    h_axis = layout.find("H")
    w_axis = layout.find("W")
    if rng.random() < 0.5:
        data = np.flip(data, axis=h_axis)
    if rng.random() < 0.5:
        data = np.flip(data, axis=w_axis)
    if aug_mode == "1":
        angle = float(rng.uniform(-180, 180))
        data = fixed_angle_rotation(np.ascontiguousarray(data), angle, h_axis, w_axis)
    elif aug_mode == "2":
        angle = float(rng.choice(np.asarray(rotation_angles)))
        data = fixed_angle_rotation(np.ascontiguousarray(data), angle, h_axis, w_axis)
    else:
        raise NotImplementedError(f"aug_mode '{aug_mode}'")
    return np.ascontiguousarray(data)
