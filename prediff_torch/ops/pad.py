"""3-D padding of (B, T, H, W, C) tensors to a multiple of a patch-merge
window or a cuboid, and its inverse: 'zeros' and 'ignore' pad with zeros at
the end of each axis ('ignore' also masks the pad out of attention, see
``ops/cuboid.py``), 'nearest' resizes by nearest neighbour."""
import torch


def _nearest_resize_thw(x: torch.Tensor, T_new: int, H_new: int, W_new: int) -> torch.Tensor:
    """Nearest resize of the T/H/W axes, index math floor(i * in / out)."""
    _, T, H, W, _ = x.shape
    dev = x.device
    t_idx = (torch.arange(T_new, device=dev) * T) // T_new
    h_idx = (torch.arange(H_new, device=dev) * H) // H_new
    w_idx = (torch.arange(W_new, device=dev) * W) // W_new
    return x[:, t_idx][:, :, h_idx][:, :, :, w_idx]


def _check_type(padding_type: str) -> None:
    if padding_type not in ("zeros", "ignore", "nearest"):
        raise ValueError(f"padding_type '{padding_type}'")


def generalize_padding(x: torch.Tensor, pad_t: int, pad_h: int, pad_w: int,
                       padding_type: str) -> torch.Tensor:
    if pad_t == 0 and pad_h == 0 and pad_w == 0:
        return x
    _check_type(padding_type)
    _, T, H, W, _ = x.shape
    if padding_type == "nearest":
        return _nearest_resize_thw(x, T + pad_t, H + pad_h, W + pad_w)
    return torch.nn.functional.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_t))


def generalize_unpadding(x: torch.Tensor, pad_t: int, pad_h: int, pad_w: int,
                         padding_type: str) -> torch.Tensor:
    """Inverse of :func:`generalize_padding`: crop the end of each axis, or
    for 'nearest' resize back."""
    _check_type(padding_type)
    if pad_t == 0 and pad_h == 0 and pad_w == 0:
        return x
    _, T, H, W, _ = x.shape
    if padding_type == "nearest":
        return _nearest_resize_thw(x, T - pad_t, H - pad_h, W - pad_w)
    return x[:, :T - pad_t, :H - pad_h, :W - pad_w, :]
