"""KITTI depth-devkit error metrics, vectorized.

Port of ``depthestimation_tpu/ops/metrics.py``: all 9 metrics in one pass
over the masked pixels, for one depth map or a batch of them, on the
tensors' device. ``eval_errors`` aggregates per-item metric vectors on
the host in f64.
"""

from __future__ import annotations

import numpy as np
import torch

METRIC_NAMES = (
    "mae",
    "rmse",
    "inverse mae",
    "inverse rmse",
    "log mae",
    "log rmse",
    "scale invariant log",
    "abs relative",
    "squared relative",
)

# The reference's zero handling: zeros become -1, then epsilon is added;
# a pixel is valid where the truth is > 0, so those pixels drop out.
_EPS = float(np.finfo(np.float64).eps)


def depth_error(predicted: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """9 KITTI metrics over pixels with valid (>0) ground truth.

    predicted/truth: [..., H, W] depth maps in meters (zeros = missing).
    Returns [..., 9] ordered as ``METRIC_NAMES``.
    """
    pred = torch.where(predicted == 0, -1.0, predicted) + _EPS
    gt = torch.where(truth == 0, -1.0, truth) + _EPS
    valid = gt > 0
    n = valid.sum(dim=(-2, -1))

    def msum(x):
        return torch.where(valid, x, 0.0).sum(dim=(-2, -1))

    d_err = torch.abs(gt - pred)
    d_err2 = d_err * d_err
    d_inv = torch.abs(1.0 / gt - 1.0 / pred)
    safe_pred = torch.where(valid, torch.clamp(pred, min=_EPS), 1.0)
    safe_gt = torch.where(valid, gt, 1.0)
    d_log = torch.log(safe_gt) - torch.log(safe_pred)

    mae = msum(d_err) / n
    rmse = torch.sqrt(msum(d_err2) / n)
    inv_mae = msum(d_inv) / n
    inv_rmse = torch.sqrt(msum(d_inv * d_inv) / n)
    log_mae = msum(torch.abs(d_log)) / n
    nsl = msum(d_log * d_log) / n
    log_rmse = torch.sqrt(nsl)
    # scale-invariant log error = std of d_log over the valid pixels, in
    # the centered two-pass form: the reference's E[x^2] - E[x]^2 cancels
    # in f32 (NaN from the sqrt of a tiny negative)
    log_mean = msum(d_log) / n
    sil = torch.sqrt(torch.clamp(
        msum((d_log - log_mean[..., None, None]) ** 2) / n, min=0.0))
    abs_rel = msum(d_err / safe_gt) / n
    sq_rel = msum(d_err2 / (safe_gt * safe_gt)) / n

    return torch.stack([mae, rmse, inv_mae, inv_rmse, log_mae, log_rmse,
                        sil, abs_rel, sq_rel], dim=-1)


def eval_errors(errors) -> dict:
    """Aggregate per-frame [9] metric vectors (a list of them, or a
    [N, 9] tensor or array) into {name: [mean, min, max]}, in f64; no
    frame gives NaNs."""
    if isinstance(errors, torch.Tensor):
        arr = errors.detach().to("cpu", torch.float64)
    elif len(errors) and isinstance(errors[0], torch.Tensor):
        arr = torch.stack([e.detach().cpu() for e in errors]).double()
    else:
        arr = torch.as_tensor(np.asarray(errors, np.float64))
    arr = arr.reshape(-1, len(METRIC_NAMES))
    if arr.shape[0] == 0:
        return {name: [float("nan")] * 3 for name in METRIC_NAMES}
    return {name: [float(arr[:, i].mean()), float(arr[:, i].min()),
                   float(arr[:, i].max())]
            for i, name in enumerate(METRIC_NAMES)}
