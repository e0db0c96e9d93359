"""Device selection and numerics for the port's entry points."""
import contextlib
from typing import Iterator, Optional, Union

import torch


def set_numerics() -> None:
    """Full-f32 matrix products and convolutions on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits), which would make the card's forecast differ from the CPU's and
    from the JAX reference by far more than the kernels' bf16 operand
    rounding.  The hand-written kernels round their matmul operands to bf16
    on purpose, at the same points as the TPU kernels; everything else stays
    f32.  This is the one place the two switches are set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def f32_numerics() -> Iterator[None]:
    """:func:`set_numerics`'s two switches off for the ``with`` block only,
    restored after: for library calls (the evaluation's convolutions and
    products) that take tensors on any device without an entry point having
    set them."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    set_numerics()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def set_deterministic() -> None:
    """cuDNN's deterministic convolution algorithms, and no autotuned choice
    among them: by default cuDNN may take a weight- or input-gradient
    algorithm that adds with atomics, and two runs of one training step, or
    two guided forecasts (whose guidance takes the alignment net's input
    gradient), then differ in the last bits.  The hand-written kernels add in
    a fixed order by themselves, and the other library ops on these paths
    (cuBLAS on one stream, ``index_put`` with accumulation, which sorts) are
    deterministic as they are, so this one switch makes a training step and a
    guided forecast repeat bit for bit.  A captured CUDA graph keeps the
    algorithms chosen when it was captured, so the switch is on before any
    capture: every entry point sets it (:func:`resolve_device`)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card.  Asking for CUDA on a host without one raises:
    an entry point never carries on quietly on the CPU.  On the card, full
    f32 numerics and cuDNN's deterministic algorithms for everything that
    runs after."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "prediff_torch runs on a CUDA device; none is available. "
                "Pass device='cpu' to run the plain PyTorch versions on the CPU."
            )
        set_numerics()
        set_deterministic()
    return dev
