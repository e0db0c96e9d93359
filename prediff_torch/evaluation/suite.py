"""Forecast evaluation suite: the reference's per-split metric set
(SEVIRSkillScore + MSE / MAE / SSIM, plus CRPS and optional FVD)
accumulated over ensembles of sampled forecasts, under the reference's
metric names.

Counterpart of ``prediff_tpu/evaluation/suite.py`` (reference: the
valid_* / test_* torchmetric suites of train_sevirlr_prediff.py, naming
:983-1086, ``valid_loss_epoch`` = -avg CSI :881-883).  ``state_tree`` has the
JAX suite's keys and numpy arrays, so a tree written by either package loads
in the other.
"""
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import gather_parts, make_mesh, process_count
from .fvd import FrechetVideoDistance, FVDState
from .metrics import MeanMetric, crps_ensemble, mae, mse, ssim
from .skill_scores import SEVIRSkillScore, SkillScoreState


class ForecastEvalSuite:
    """Accumulates one suite (aligned or unaligned) of forecast metrics.

    ``update`` takes an ensemble ``preds`` (M, B, T, H, W, C) and the target
    (B, T, H, W, C) on one device: the skill score, MSE, MAE and SSIM are
    updated per member (weighted by element counts), FVD sees every member
    as fake and the target once as real, CRPS the whole ensemble when M > 1.
    """

    def __init__(self, layout: str = "NTHWC", metrics_mode: str = "0",
                 seq_len: Optional[int] = None,
                 threshold_list: Sequence[int] = (16, 74, 133, 160, 181, 219),
                 metrics_list: Sequence[str] = ("csi", "pod", "sucr", "bias"),
                 fvd: Optional[FrechetVideoDistance] = None):
        self.score = SEVIRSkillScore(layout=layout, mode=metrics_mode, seq_len=seq_len,
                                     threshold_list=tuple(threshold_list),
                                     metrics_list=tuple(metrics_list))
        self.threshold_list = tuple(threshold_list)
        self.metrics_list = tuple(metrics_list)
        self.mse = MeanMetric()
        self.mae = MeanMetric()
        self.ssim = MeanMetric()
        self.crps = MeanMetric()
        self.fvd = fvd

    def update(self, preds: torch.Tensor, target: torch.Tensor):
        if preds.ndim != target.ndim + 1:
            raise ValueError(f"preds {tuple(preds.shape)} must be target {tuple(target.shape)} "
                             "with a leading ensemble axis")
        for pred in preds:
            self.score.update(pred, target)
            n_el = pred.numel()
            self.mse.update(mse(pred, target), weight=n_el)
            self.mae.update(mae(pred, target), weight=n_el)
            B, T = pred.shape[:2]
            self.ssim.update(ssim(pred.reshape((B * T,) + tuple(pred.shape[2:])),
                                  target.reshape((B * T,) + tuple(target.shape[2:]))),
                             weight=B * T)  # torchmetrics SSIM: mean over images
            if self.fvd is not None:
                self.fvd.update(pred, real=False)
        if self.fvd is not None:
            self.fvd.update(target, real=True)
        if preds.shape[0] > 1:
            self.crps.update(crps_ensemble(preds, target), weight=target.numel())

    # ---- shard / cross-process reduction ------------------------------ #
    def merge(self, other: "ForecastEvalSuite"):
        """Sum the other suite's state into this one (every state is an
        additive count or sum)."""
        self.score.state = self.score.state.merge(other.score.state)
        for mine, theirs in ((self.mse, other.mse), (self.mae, other.mae),
                             (self.ssim, other.ssim), (self.crps, other.crps)):
            mine.merge(theirs)
        if self.fvd is not None and other.fvd is not None:
            self.fvd.real = self.fvd.real.merge(other.fvd.real)
            self.fvd.fake = self.fvd.fake.merge(other.fvd.fake)
        return self

    def state_tree(self) -> Dict[str, np.ndarray]:
        """Additive numeric state as a flat dict of numpy arrays."""
        tree = {"hits": self.score.state.hits.cpu().numpy(),
                "misses": self.score.state.misses.cpu().numpy(),
                "fas": self.score.state.fas.cpu().numpy(),
                "mse": np.asarray([self.mse.total, self.mse.count]),
                "mae": np.asarray([self.mae.total, self.mae.count]),
                "ssim": np.asarray([self.ssim.total, self.ssim.count]),
                "crps": np.asarray([self.crps.total, self.crps.count])}
        if self.fvd is not None:
            for name, st in (("real", self.fvd.real), ("fake", self.fvd.fake)):
                tree[f"fvd_{name}_sum"] = st.features_sum.cpu().numpy()
                tree[f"fvd_{name}_cov"] = st.features_cov_sum.cpu().numpy()
                tree[f"fvd_{name}_n"] = st.num_samples.cpu().numpy()
        return tree

    def load_state_tree(self, tree: Dict):
        def tensor(a):
            return torch.tensor(np.asarray(a))

        self.score.state = SkillScoreState(hits=tensor(tree["hits"]),
                                           misses=tensor(tree["misses"]),
                                           fas=tensor(tree["fas"]))
        for name, m in (("mse", self.mse), ("mae", self.mae), ("ssim", self.ssim),
                        ("crps", self.crps)):
            m.total, m.count = float(tree[name][0]), float(tree[name][1])
        if self.fvd is not None and "fvd_real_sum" in tree:
            for name in ("real", "fake"):
                setattr(self.fvd, name, FVDState(
                    features_sum=tensor(tree[f"fvd_{name}_sum"]),
                    features_cov_sum=tensor(tree[f"fvd_{name}_cov"]),
                    num_samples=tensor(tree[f"fvd_{name}_n"])))

    def cross_process_reduce(self):
        """Sum the metric state of every rank of ``torch.distributed`` before
        ``compute()`` (the reference's torchmetrics ``dist_reduce_fx="sum"``,
        train_sevirlr_prediff.py:818-819); nothing to do in one process.  As
        the JAX suite's ``process_allgather``: every leaf of ``state_tree`` is
        gathered from every rank and summed in rank order in its own dtype, so
        every rank holds the same state, the ``merge`` of the ranks' suites
        bit for bit (an all-reduce would sum in an order of NCCL's choosing)."""
        if process_count() == 1:
            return self
        # the state is the host's: a gloo group gathers it there, NCCL on the card
        mesh = make_mesh(device="cpu" if dist.get_backend() == "gloo" else None)
        tree = {}
        for name, leaf in self.state_tree().items():
            parts = gather_parts(torch.from_numpy(np.array(leaf)), mesh)   # 0-d stays 0-d
            total = parts[0].numpy()
            for part in parts[1:]:
                total = total + part.numpy()
            tree[name] = total
        self.load_state_tree(tree)
        return self

    def compute(self, prefix: str) -> Dict[str, float]:
        """Epoch-end metrics in the reference's key scheme; also
        ``{prefix}_loss_epoch = -csi_avg`` (the checkpoint monitor)."""
        out: Dict[str, float] = {f"{prefix}_mse_epoch": self.mse.compute(),
                                 f"{prefix}_mae_epoch": self.mae.compute(),
                                 f"{prefix}_ssim_epoch": self.ssim.compute()}
        scores = self.score.compute()
        for metric in self.metrics_list:
            for th in self.threshold_list:
                out[f"{prefix}_{metric}_{th}_epoch"] = float(np.mean(scores[th][metric]))
            out[f"{prefix}_{metric}_avg_epoch"] = float(np.mean(scores["avg"][metric]))
        if "csi" in self.metrics_list:
            out[f"{prefix}_loss_epoch"] = -out[f"{prefix}_csi_avg_epoch"]
        if self.crps.count:
            out[f"{prefix}_crps_epoch"] = self.crps.compute()
        if self.fvd is not None:
            out[f"{prefix}_fvd_epoch"] = self.fvd.compute()
        return out

    def reset(self):
        self.score.reset()
        for m in (self.mse, self.mae, self.ssim, self.crps):
            m.reset()
        if self.fvd is not None:
            self.fvd.reset()
