"""BraTS label-space maps on channels-last tensors (counterpart of
``segtran_tpu/data/labelmaps3d.py``; reference datasets3d.py:16-88)."""
from __future__ import annotations

import torch


def brats_map_label(mask: torch.Tensor, binarize: bool = False) -> torch.Tensor:
    """Raw labels [..., H, W, D] in {0, 1, 2, 3} -> n-hot [..., 4]
    (bg, ET, WT, TC) fp32, WT >= TC >= ET."""
    if binarize:
        return torch.stack([mask == 0, mask > 0], dim=-1).float()
    bg = mask == 0
    et = mask == 3
    wt = (mask == 1) | (mask == 2) | (mask == 3)
    tc = (mask == 1) | (mask == 3)
    return torch.stack([bg, et, wt, tc], dim=-1).float()


def make_brats_pred_consistent(preds_soft: torch.Tensor,
                               is_conservative: bool = False) -> torch.Tensor:
    """Enforce the class nesting on soft predictions [..., 4]: max-fix
    (WT = max(ET, WT, TC), TC = max(ET, TC)), or min-fix if conservative."""
    bg, et, wt, tc = preds_soft.unbind(-1)
    if is_conservative:
        return torch.stack([bg, torch.minimum(torch.minimum(et, wt), tc), wt,
                            torch.minimum(wt, tc)], dim=-1)
    return torch.stack([bg, et, torch.maximum(torch.maximum(et, wt), tc),
                        torch.maximum(et, tc)], dim=-1)


def brats_inv_map_label(orig_probs: torch.Tensor,
                        up: float = 1.5) -> torch.Tensor:
    """n-hot probs [..., 4] -> raw-label probs [..., 4] for labels 0..3,
    with the reference's 1.5x boost of labels 1 and 2."""
    et, wt, tc = orig_probs[..., 1], orig_probs[..., 2], orig_probs[..., 3]
    return torch.stack([1.0 - wt, (tc - et) * up, (wt - tc) * up, et], dim=-1)
