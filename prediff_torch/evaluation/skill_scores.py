"""SEVIR skill scores (CSI / POD / SUCR / BIAS) as an accumulator of
hits, misses and false alarms per threshold.

Counterpart of ``prediff_tpu/evaluation/skill_scores.py`` (reference
SEVIRSkillScore, src/prediff/datasets/sevir/evaluation.py:88).  The counts
are f32 tensors on the device of the updates, as the JAX state is; scores
are computed on the host in numpy.

Modes:
  "0": counts pooled over all pixels; scores per threshold + threshold-avg
  "1": per-lead-time counts; scores keep the (seq_len,) dim
  "2": per-lead-time counts; scores averaged over lead time at compute()
``preprocess_type="sevir_pool{x}"`` max-pools pred / target by x over H
and W before thresholding.
"""
import re
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


def _rescale_to_255(x: torch.Tensor) -> torch.Tensor:
    """[0,1] VIL back to 0-255 (ref: process_data_dict_back with '01')."""
    return x * 255.0


def _max_pool_hw(x: torch.Tensor, scale: int, layout: str) -> torch.Tensor:
    h_axis, w_axis = layout.find("H"), layout.find("W")
    n_h, n_w = x.shape[h_axis] // scale, x.shape[w_axis] // scale
    x = x.narrow(h_axis, 0, n_h * scale).narrow(w_axis, 0, n_w * scale)
    shape = list(x.shape)
    shape[h_axis:h_axis + 1] = [n_h, scale]
    x = x.reshape(shape).amax(dim=h_axis + 1)
    shape = list(x.shape)
    shape[w_axis:w_axis + 1] = [n_w, scale]
    return x.reshape(shape).amax(dim=w_axis + 1)


def threshold_counts(pred: torch.Tensor, target: torch.Tensor, thresholds: Sequence[float],
                     reduce_dims: Tuple[int, ...]
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hits, misses and false alarms per threshold, f32; a NaN in either
    input counts as 0 everywhere.  Returns tensors of shape
    (num_thresholds, *kept_dims)."""
    is_nan = torch.logical_or(torch.isnan(pred), torch.isnan(target))[None]
    th = torch.as_tensor(thresholds, dtype=pred.dtype,
                         device=pred.device).reshape((-1,) + (1,) * pred.ndim)
    zero = torch.zeros((), dtype=torch.float32, device=pred.device)
    t = torch.where(is_nan, zero, (target[None] >= th).to(torch.float32))
    p = torch.where(is_nan, zero, (pred[None] >= th).to(torch.float32))
    dims = tuple(d + 1 for d in reduce_dims)
    hits = torch.sum(t * p, dim=dims)
    misses = torch.sum(t * (1 - p), dim=dims)
    fas = torch.sum((1 - t) * p, dim=dims)
    return hits, misses, fas


@dataclass
class SkillScoreState:
    hits: torch.Tensor
    misses: torch.Tensor
    fas: torch.Tensor

    def to(self, device) -> "SkillScoreState":
        return SkillScoreState(self.hits.to(device), self.misses.to(device), self.fas.to(device))

    def merge(self, other: "SkillScoreState") -> "SkillScoreState":
        """The sums of the two states, on this state's device."""
        other = other.to(self.hits.device)
        return SkillScoreState(hits=self.hits + other.hits, misses=self.misses + other.misses,
                               fas=self.fas + other.fas)


class SEVIRSkillScore:
    def __init__(self, layout: str = "NTHWC", mode: str = "0", seq_len: Optional[int] = None,
                 preprocess_type: str = "sevir",
                 threshold_list: Sequence[int] = (16, 74, 133, 160, 181, 219),
                 metrics_list: Sequence[str] = ("csi", "bias", "sucr", "pod"),
                 eps: float = 1e-4):
        if not (preprocess_type == "sevir" or preprocess_type.startswith("sevir_pool")):
            raise ValueError(f"preprocess_type '{preprocess_type}'")
        if mode not in ("0", "1", "2"):
            raise ValueError(f"mode '{mode}'")
        self.layout = layout
        self.mode = mode
        self.seq_len = seq_len
        self.preprocess_type = preprocess_type
        self.threshold_list = tuple(threshold_list)
        self.metrics_list = tuple(metrics_list)
        self.eps = eps
        self.keep_seq_len_dim = mode in ("1", "2")
        if self.keep_seq_len_dim and not isinstance(seq_len, int):
            raise ValueError(f"mode '{mode}' needs an integer seq_len")
        dims = list(range(len(layout)))
        if self.keep_seq_len_dim:
            dims.pop(layout.find("T"))
        self.reduce_dims = tuple(dims)
        self.reset()

    def init_state(self) -> SkillScoreState:
        shape = ((len(self.threshold_list), self.seq_len) if self.keep_seq_len_dim
                 else (len(self.threshold_list),))
        z = torch.zeros(shape, dtype=torch.float32)
        return SkillScoreState(hits=z, misses=z.clone(), fas=z.clone())

    def reset(self):
        self.state = self.init_state()

    def update(self, pred: torch.Tensor, target: torch.Tensor):
        """pred / target in [0, 1] VIL scale, layout ``self.layout``; the
        state moves to their device."""
        pred = _rescale_to_255(pred)
        target = _rescale_to_255(target)
        if self.preprocess_type.startswith("sevir_pool"):
            scale = int(re.search(r"\d+", self.preprocess_type).group())
            pred = _max_pool_hw(pred, scale, self.layout)
            target = _max_pool_hw(target, scale, self.layout)
        hits, misses, fas = threshold_counts(pred, target, self.threshold_list, self.reduce_dims)
        self.state = self.state.to(pred.device).merge(
            SkillScoreState(hits=hits, misses=misses, fas=fas))

    # score functions -------------------------------------------------- #
    @staticmethod
    def pod(h, m, f, eps):
        return h / (h + m + eps)

    @staticmethod
    def sucr(h, m, f, eps):
        return h / (h + f + eps)

    @staticmethod
    def csi(h, m, f, eps):
        return h / (h + m + f + eps)

    @staticmethod
    def bias(h, m, f, eps):
        # the reference's formula as the JAX package computes it
        bias = (h + f) / (h + m + eps)
        return np.power(bias / np.log(2.0), 2.0)

    def compute(self, state: Optional[SkillScoreState] = None) -> Dict:
        state = state if state is not None else self.state
        fns = {"pod": self.pod, "csi": self.csi, "sucr": self.sucr, "bias": self.bias}
        hits = state.hits.cpu().numpy()
        misses = state.misses.cpu().numpy()
        fas = state.fas.cpu().numpy()
        ret: Dict = {th: {} for th in self.threshold_list}
        ret["avg"] = {}
        for metric in self.metrics_list:
            scores = fns[metric](hits, misses, fas, self.eps)
            score_avg = np.zeros((self.seq_len,)) if self.keep_seq_len_dim else 0.0
            for i, th in enumerate(self.threshold_list):
                score = scores[i] if self.keep_seq_len_dim else float(scores[i])
                if self.mode in ("0", "1"):
                    ret[th][metric] = score
                else:  # "2"
                    ret[th][metric] = float(np.mean(score))
                score_avg += score
            score_avg /= len(self.threshold_list)
            ret["avg"][metric] = float(np.mean(score_avg)) if self.mode == "2" else score_avg
        return ret
