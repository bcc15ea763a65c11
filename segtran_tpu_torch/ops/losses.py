"""Segmentation losses (counterpart of ``segtran_tpu/ops/losses.py``;
reference code/utils/losses.py:47-60 and BCEWithLogitsLoss(pos_weight))."""
from __future__ import annotations

from typing import Optional

import torch

_SMOOTH = 1e-5


def dice_loss_indiv(score: torch.Tensor, gt_mask: torch.Tensor,
                    weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-example Dice loss averaged over the batch; score [B, ...] is
    already sigmoided, z_sum = sum(score^2) as in the reference."""
    b = score.shape[0]
    score = score.reshape(b, -1).float()
    gt = gt_mask.reshape(b, -1).float()
    intersect = (score * gt).sum(1)
    y_sum = (gt * gt).sum(1)
    z_sum = (score * score).sum(1)
    loss = 1.0 - (2.0 * intersect + _SMOOTH) / (z_sum + y_sum + _SMOOTH)
    return (loss * weight).mean() if weight is not None else loss.mean()


def weighted_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                             pos_weight: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Stable BCE-with-logits, mean over every element; ``pos_weight`` is
    shaped to broadcast over the class axis (torch BCEWithLogitsLoss)."""
    logits = logits.float()
    targets = targets.float()
    log1p = torch.log1p(torch.exp(-logits.abs()))
    log_sig = torch.clamp(logits, max=0.0) - log1p
    log_one_minus = -torch.clamp(logits, min=0.0) - log1p
    pos = targets * log_sig if pos_weight is None \
        else pos_weight * targets * log_sig
    return (-(pos + (1.0 - targets) * log_one_minus)).mean()
