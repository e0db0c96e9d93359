"""SEVIR visualization: the VIL colormap, sequence panels, hit / miss /
false-alarm maps and GIF export, on numpy arrays or tensors.

Counterpart of ``prediff_tpu/datasets/visualization.py`` (reference
``vis_sevir_seq``, datasets/sevir/visualization.py:45; ``plot_hit_miss_fa``
:22; the VIL color levels of the public SEVIR benchmark, sevir_cmap.py;
``save_gif``, utils/gifmaker.py:5).  matplotlib and PIL are imported when a
function needs them; without them the call raises ``ImportError`` naming the
package (the card's machine may lack both).
"""
from typing import Optional, Sequence, Union

import numpy as np
import torch

# SEVIR benchmark VIL color levels (0-255 encoded scale)
VIL_COLORS = [
    [0, 0, 0],
    [0.30196078431372547, 0.30196078431372547, 0.30196078431372547],
    [0.1568627450980392, 0.7450980392156863, 0.1568627450980392],
    [0.09803921568627451, 0.5882352941176471, 0.09803921568627451],
    [0.0392156862745098, 0.4117647058823529, 0.0392156862745098],
    [0.0392156862745098, 0.29411764705882354, 0.0392156862745098],
    [0.9607843137254902, 0.9607843137254902, 0.0],
    [0.9294117647058824, 0.6745098039215687, 0.0],
    [0.9411764705882353, 0.43137254901960786, 0.0],
    [0.6274509803921569, 0.0, 0.0],
    [0.9058823529411765, 0.0, 1.0],
]
VIL_LEVELS = [0.0, 16.0, 31.0, 59.0, 74.0, 100.0, 133.0, 160.0, 181.0, 219.0, 255.0]

ArrayLike = Union[np.ndarray, torch.Tensor]


def _matplotlib():
    """matplotlib on its file backend (Agg), or ``ImportError`` naming it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is required for the SEVIR panels "
                          "(prediff_torch.datasets.visualization)") from e
    matplotlib.use("Agg")
    return matplotlib


def _numpy(a: ArrayLike) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float().numpy()
    return np.asarray(a)


def vil_cmap():
    """(cmap, norm) for encoded VIL (0-255)."""
    _matplotlib()
    from matplotlib.colors import BoundaryNorm, ListedColormap

    cols = [list(c) for c in VIL_COLORS]
    cmap = ListedColormap(cols[1:-1])
    cmap.set_bad(cols[0])
    cmap.set_under(cols[0])
    cmap.set_over(cols[-1])
    return cmap, BoundaryNorm(VIL_LEVELS[1:-1], cmap.N)


def get_cmap(typ: str):
    """(cmap, norm, vmin, vmax) by data type: the VIL colormap, ``hot`` for
    lightning, ``jet`` otherwise."""
    if typ.lower() == "vil":
        cmap, norm = vil_cmap()
        return cmap, norm, None, None
    if typ.lower() == "lght":
        return "hot", None, 0, 5
    return "jet", None, None, None


def plot_hit_miss_fa(ax, y_true: ArrayLike, y_pred: ArrayLike, thres: float) -> None:
    """Color-coded hit (gold) / miss (tomato) / false-alarm (blue) map on ``ax``."""
    _matplotlib()
    from matplotlib.colors import ListedColormap

    y_true, y_pred = _numpy(y_true), _numpy(y_pred)
    mask = np.zeros_like(y_true)
    mask[np.logical_and(y_true >= thres, y_pred >= thres)] = 4  # hit
    mask[np.logical_and(y_true >= thres, y_pred < thres)] = 3   # miss
    mask[np.logical_and(y_true < thres, y_pred >= thres)] = 2   # false alarm
    mask[np.logical_and(y_true < thres, y_pred < thres)] = 1    # correct rejection
    cmap = ListedColormap(["silver", "dodgerblue", "tomato", "gold"])
    ax.imshow(mask, cmap=cmap, vmin=1, vmax=4)


def vis_sevir_seq(save_path: str, seq: Union[ArrayLike, Sequence[ArrayLike]],
                  label: Union[str, Sequence[str]] = "pred", norm: Optional[dict] = None,
                  interval_real_time: float = 10.0, plot_stride: int = 2,
                  label_rotation: int = 0, label_offset: Sequence[float] = (-0.06, 0.4),
                  label_avg_int: bool = False, fs: int = 10, max_cols: int = 10) -> None:
    """A PNG of labeled rows (context / target / predictions), each a
    (T, H, W[, 1]) sequence in [0, 1], in the SEVIR VIL colormap."""
    _matplotlib()
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    if isinstance(seq, (np.ndarray, torch.Tensor)):
        seq_list, label_list = [_numpy(seq).astype(np.float32)], [label]
    else:
        seq_list, label_list = [_numpy(s).astype(np.float32) for s in seq], list(label)
    if norm is None:
        norm = {"scale": 255, "shift": 0}
    nrows = len(seq_list)
    ncols = min(max(len(s) for s in seq_list) // plot_stride, max_cols)
    fig, axes = plt.subplots(nrows=nrows, ncols=ncols, figsize=(3 * ncols, 3 * nrows),
                             squeeze=False)
    cmap, cnorm, _, _ = get_cmap("vil")
    for i, (s, lab) in enumerate(zip(seq_list, label_list)):
        for j in range(ncols):
            t = j * plot_stride
            if t < len(s):
                frame = s[t].squeeze() * norm["scale"] + norm["shift"]
                axes[i][j].imshow(frame, cmap=cmap, norm=cnorm)
                if label_avg_int:
                    axes[i][j].set_title(f"avg={frame.mean():.1f}", fontsize=fs)
            axes[i][j].axis("off")
            if i == nrows - 1:
                axes[i][j].set_title(f"{int(interval_real_time * (t + 1))} min", fontsize=fs,
                                     y=-0.2)
        axes[i][0].text(label_offset[0], label_offset[1], lab, fontsize=fs,
                        rotation=label_rotation, transform=axes[i][0].transAxes, ha="right",
                        va="center")
    legend = [Patch(facecolor=VIL_COLORS[i + 1],
                    label=f"{int(VIL_LEVELS[i + 1])}-{int(VIL_LEVELS[i + 2])}")
              for i in range(len(VIL_COLORS) - 2)]
    fig.legend(handles=legend, loc="center right", fontsize=fs, borderaxespad=0.1)
    plt.subplots_adjust(right=0.9)
    fig.savefig(save_path, bbox_inches="tight")
    plt.close(fig)


def save_gif(single_seq: ArrayLike, fname: str, fps: int = 4) -> None:
    """An animated GIF of a (T, H, W[, 1]) sequence in [0, 1]."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL (pillow) is required for save_gif") from e
    frames = [Image.fromarray((np.clip(f.squeeze(), 0, 1) * 255).astype(np.uint8))
              for f in _numpy(single_seq)]
    frames[0].save(fname, save_all=True, append_images=frames[1:], duration=int(1000 / fps),
                   loop=0)
