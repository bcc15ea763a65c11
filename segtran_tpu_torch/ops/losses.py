"""Segmentation losses and the vCDR (counterpart of
``segtran_tpu/ops/losses.py``; reference code/utils/losses.py:7-127 and
BCEWithLogitsLoss(pos_weight))."""
from __future__ import annotations

from typing import Optional

import torch

from .norm import global_sum

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


def smooth_dice_loss(score: torch.Tensor, gt_mask: torch.Tensor,
                     running_denom: torch.Tensor, momentum: float = 0.1):
    """Dice with a running-average denominator offset (reference
    utils/losses.py:7-44 SmoothDiceLoss). The state is explicit: pass the
    previous ``running_denom`` (a scalar; < 0 means not yet set) and keep
    the returned one. Returns (smooth_loss, orig_loss, new_running_denom)."""
    eps = 1e-5
    b = score.shape[0]
    s = score.reshape(b, -1).float()
    g = gt_mask.reshape(b, -1).float()
    intersect = (s * g).sum(1)
    denom = (s * s).sum(1) + (g * g).sum(1) + eps
    mean_denom = denom.mean()
    unset = running_denom < 0
    new_running = torch.where(unset, mean_denom,
                              running_denom * (1 - momentum)
                              + mean_denom * momentum)
    dyn_offset = torch.where(unset, torch.zeros_like(denom),
                             new_running - denom.detach())
    smooth_dice = (2 * intersect + eps + dyn_offset) / (denom + dyn_offset)
    orig_dice = (2 * intersect + eps) / denom
    return (1 - smooth_dice).mean(), (1 - orig_dice).mean(), new_running


def dice_loss_mix(score: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    """Whole-batch Dice loss with plain (unsquared) sums in the denominator
    (reference utils/losses.py:63-71); its sums span the global batch
    within ``ops.norm.global_batch``."""
    score, gt = score.float(), gt_mask.float()
    sums = global_sum(torch.stack([(score * gt).sum(), score.sum() + gt.sum()]))
    dice = (2.0 * sums[0] + _SMOOTH) / (sums[1] + _SMOOTH)
    return 1.0 - dice


def calc_vcdr_batch(mask_nhot_soft: torch.Tensor, thres: float = 0.5
                    ) -> torch.Tensor:
    """Vertical cup-to-disc ratio [B] of [B, H, W, C] masks (channel 1
    disc, 2 cup), the reference's batched branch (utils/losses.py:76-97):
    an extent is max - min over the 1-based row indices of the occupied
    rows with every unoccupied row counted as index 0, so the min is 0
    whenever a row is empty."""
    mask = mask_nhot_soft >= thres
    h = mask.shape[1]
    rows = torch.arange(1, h + 1, dtype=torch.float32, device=mask.device)

    def extent(channel):                     # [B, H, W] bool -> [B]
        idx = channel.any(2).float() * rows
        return idx.max(1).values - idx.min(1).values

    return extent(mask[..., 2]) / (extent(mask[..., 1]) + 1e-4)


def calc_vcdr_eval(mask_nhot_soft: torch.Tensor, thres: float = 0.5,
                   delta: int = 1) -> torch.Tensor:
    """Per-image vCDR [B] with the reference eval's per-image semantics
    (utils/losses.py:99-127, reached through calc_batch_metric): an extent
    is max - min - ``delta`` over the occupied rows only; an image with no
    disc gives -1, one with a disc and no cup 0."""
    mask = mask_nhot_soft >= thres
    h = mask.shape[1]
    rows = torch.arange(1, h + 1, dtype=torch.float32, device=mask.device)
    inf = torch.tensor(float("inf"), device=mask.device)

    def extent(channel):                     # -> (length [B], found [B])
        occupied = channel.any(2)
        mx = torch.where(occupied, rows, -inf).max(1).values
        mn = torch.where(occupied, rows, inf).min(1).values
        return mx - mn - delta, occupied.any(1)

    disc_len, has_disc = extent(mask[..., 1])
    cup_len, has_cup = extent(mask[..., 2])
    vcdr = torch.where(has_cup, cup_len / (disc_len + 1e-4),
                       torch.zeros_like(cup_len))
    return torch.where(has_disc, vcdr, torch.full_like(vcdr, -1.0))
