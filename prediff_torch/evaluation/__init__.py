"""Forecast evaluation on any device: SEVIR skill scores, MSE / MAE / SSIM,
ensemble CRPS, FVD with an I3D extractor, and the suite that gathers them
(counterpart of ``prediff_tpu/evaluation``)."""
from .skill_scores import SEVIRSkillScore, threshold_counts
from .metrics import MeanMetric, mse, mae, ssim, crps_ensemble, pearson_corr
from .fvd import (FrechetVideoDistance, FVDState, InceptionI3d, frechet_distance,
                  i3d_feature_fn, preprocess_video, seeded_i3d)
from .suite import ForecastEvalSuite

__all__ = ["SEVIRSkillScore", "threshold_counts", "MeanMetric", "mse", "mae", "ssim",
           "crps_ensemble", "pearson_corr", "FrechetVideoDistance", "FVDState", "InceptionI3d",
           "frechet_distance", "i3d_feature_fn", "preprocess_video", "seeded_i3d",
           "ForecastEvalSuite"]
