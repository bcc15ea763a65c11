"""Task label-space maps on channels-last tensors (counterpart of
``segtran_tpu/data/labelmaps.py``; reference datasets2d.py:155-249)."""
from __future__ import annotations

import torch


def harden_segmap(mask_soft: torch.Tensor, thres: float = 0.5) -> torch.Tensor:
    """Soft n-hot [..., C] -> hard n-hot; background = no other class fired
    (reference datasets2d.py:178-196)."""
    hard = (mask_soft >= thres).to(torch.int32)
    bg = (hard[..., 1:].sum(-1) == 0).to(torch.int32)
    return torch.cat([bg[..., None], hard[..., 1:]], dim=-1)


def fundus_inv_map_mask(mask_nhot: torch.Tensor) -> torch.Tensor:
    """n-hot [..., 3] -> REFUGE grayscale (255 bg / 128 disc / 0 cup); later
    channels override earlier ones (reference :155-167)."""
    out = torch.zeros(mask_nhot.shape[:-1], dtype=torch.uint8,
                      device=mask_nhot.device)
    out = torch.where(mask_nhot[..., 0] == 1, 255, out)
    out = torch.where(mask_nhot[..., 1] == 1, 128, out)
    out = torch.where(mask_nhot[..., 2] == 1, 0, out)
    return out.to(torch.uint8)


def polyp_inv_map_mask(mask_nhot: torch.Tensor) -> torch.Tensor:
    """n-hot [..., 2] -> 0 background / 255 polyp."""
    out = torch.zeros(mask_nhot.shape[:-1], dtype=torch.uint8,
                      device=mask_nhot.device)
    return torch.where(mask_nhot[..., 1] == 1, 255, out).to(torch.uint8)
