"""Task label-space maps on channels-last tensors (counterpart of
``segtran_tpu/data/labelmaps.py``; reference datasets2d.py:22-249). The
raw-mask maps take the loader's masks as they reach the device: uint8
``[..., H, W, C]`` (or ``[..., H, W]``), and return float32 n-hot
``[..., C']``."""
from __future__ import annotations

import torch


def index_to_onehot(mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer mask [..., H, W] -> float32 one-hot [..., H, W, C]."""
    return torch.nn.functional.one_hot(mask.long(), num_classes).float()


def onehot_inv_map(mask_onehot: torch.Tensor) -> torch.Tensor:
    """One-hot [..., C] -> uint8 class index [...] (argmax)."""
    return mask_onehot.argmax(-1).to(torch.uint8)


def fundus_map_mask(mask: torch.Tensor, exclusive: bool = False
                    ) -> torch.Tensor:
    """REFUGE raw mask -> 3-channel n-hot [..., 3] (background, disc, cup;
    the disc includes the cup unless ``exclusive``). Two raw encodings
    (reference :106-138): channels [..., H, W, >=2] (ch0 >= 1 disc, ch1 >= 1
    cup), or grayscale [..., H, W] / [..., H, W, 1] (255 background, 128
    disc, 0 cup)."""
    if mask.dim() >= 3 and mask.shape[-1] == 1:
        mask = mask[..., 0]
    elif mask.dim() >= 3 and mask.shape[-1] >= 2:
        ch0, ch1 = mask[..., 0], mask[..., 1]
        disc = (ch0 >= 1) & (ch1 == 0) if exclusive else ch0 >= 1
        return torch.stack([ch0 == 0, disc, ch1 >= 1], -1).float()
    disc = mask == 128 if exclusive else mask <= 128
    return torch.stack([mask == 255, disc, mask == 0], -1).float()


def polyp_map_mask(mask: torch.Tensor, exclusive: bool = True
                   ) -> torch.Tensor:
    """Polyp raw mask (ch0: 0 background, > 0 polyp) -> 2-channel n-hot;
    [..., H, W], [..., H, W, 1] or channels [..., H, W, <= 4]."""
    ch0 = mask[..., 0] if (mask.dim() >= 3 and mask.shape[-1] <= 4) else mask
    return torch.stack([ch0 == 0, ch0 > 0], -1).float()


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
