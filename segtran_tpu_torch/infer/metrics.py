"""Evaluation metrics: per-image 2-D Dice on tensors, and for volumes
Hausdorff95 / average surface distance through medpy where it is
installed (a volume's Dice and Jaccard come from voxel counts on the
device, ``parallel/spatial.slab_overlap``; counterpart of
``segtran_tpu/infer/metrics.py``; reference test_util2d.py:229-265,
test_util3d.py:186-215)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def have_medpy() -> bool:
    try:
        from medpy.metric import binary as _  # noqa: F401
        return True
    except ImportError:
        return False


def log_metric_stack(logger) -> None:
    """Say once which metrics will be reported: without medpy the surface
    metrics are NaN and left out of the averages."""
    if have_medpy():
        logger.info("metric stack: dice, jaccard, hd95, asd (medpy present)")
    else:
        logger.info("metric stack: dice, jaccard only -- medpy not installed,"
                    " hd95/asd will be NaN and excluded from averages")


def dice_score(pred: torch.Tensor, gt: torch.Tensor,
               smooth: float = 1e-5) -> torch.Tensor:
    """Dice over the last two dims (binary or soft, same shapes), squared
    sums in the denominator (reference calc_dice, test_util2d.py:229-238)."""
    pred, gt = pred.float(), gt.float()
    dims = (-2, -1)
    inter = (pred * gt).sum(dims)
    denom = (pred * pred).sum(dims) + (gt * gt).sum(dims)
    return (2 * inter + smooth) / (denom + smooth)


def batch_dice_per_class(pred_hard: torch.Tensor, gt: torch.Tensor,
                         num_classes: int) -> torch.Tensor:
    """[B, ..., C] hard predictions and ground truth -> Dice [B, C - 1] of
    the classes after the background (reference calc_batch_metric,
    test_util2d.py:241-265)."""
    b = pred_hard.shape[0]
    p = pred_hard.reshape(b, -1, pred_hard.shape[-1])[..., 1:num_classes]
    g = gt.reshape(b, -1, gt.shape[-1])[..., 1:num_classes]
    p, g = p.float(), g.float()
    inter = (p * g).sum(1)
    denom = (p * p).sum(1) + (g * g).sum(1)
    return (2 * inter + 1e-5) / (denom + 1e-5)


def surface_metrics(pred: np.ndarray, gt: np.ndarray,
                    spacing: Optional[tuple] = None):
    """(hd95, asd) through medpy, or (nan, nan) without medpy or with an
    empty mask."""
    try:
        from medpy.metric import binary as mb
    except ImportError:
        return float("nan"), float("nan")
    if pred.sum() == 0 or gt.sum() == 0:
        return float("nan"), float("nan")
    return (float(mb.hd95(pred, gt, voxelspacing=spacing)),
            float(mb.asd(pred, gt, voxelspacing=spacing)))
