"""On-device 3-D augmentation of the training step (counterpart of the
3-D part of ``segtran_tpu/data/augment.py``; reference
datasets3d.py:497-508, 568-580, 611-665).

Each augmentation is split into its random draws (from an explicit
``torch.Generator``) and a deterministic transform that takes them, so a
test can feed the draws the JAX functions made.
"""
from __future__ import annotations

from typing import Tuple

import torch


def rot_flip_draws(batch: int, generator=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per sample: quarter turns k in [0, 4), flip H, flip W (CPU tensors)."""
    k = torch.randint(0, 4, (batch,), generator=generator)
    flips = torch.rand((2, batch), generator=generator) < 0.5
    return k, flips[0], flips[1]


def rot_flip_3d(image: torch.Tensor, label: torch.Tensor, k: int,
                flip_h: bool, flip_w: bool):
    """RandomRotFlip of one sample: k quarter turns in the HW plane, then
    the flips. image [H, W, D, C]; label [H, W, D] raw."""
    image, label = torch.rot90(image, k, (0, 1)), torch.rot90(label, k, (0, 1))
    if flip_h:
        image, label = image.flip(0), label.flip(0)
    if flip_w:
        image, label = image.flip(1), label.flip(1)
    return image, label


def resized_crop_draw(scale: float, generator=None) -> float:
    """The batch's zoom factor, uniform in [1 - scale, 1 + scale)."""
    u = float(torch.rand((), generator=generator))
    return (1.0 - scale) + 2.0 * scale * u


def _lerp_axis(vol, axis, coords):
    n = vol.shape[axis]
    i0 = torch.floor(coords).long()
    i1 = torch.clamp(i0 + 1, max=n - 1)
    shape = [1] * vol.dim()
    shape[axis] = coords.shape[0]
    w = (coords - i0.float()).reshape(shape).to(vol.dtype)
    a, b = vol.index_select(axis, i0), vol.index_select(axis, i1)
    return a * (1.0 - w) + b * w


def resized_crop_3d(images: torch.Tensor, masks: torch.Tensor, f: float):
    """Batch-level RandomResizedCrop by the zoom factor ``f``: resample the
    centre window scaled by f (trilinear for images, nearest for masks),
    zero where the window leaves the volume. images, masks
    [B, H, W, D, C]."""
    h, w, d = images.shape[1:4]
    dev = images.device
    grids, valids = [], []
    for n in (h, w, d):
        c = (torch.arange(n, dtype=torch.float32, device=dev)
             - (n - 1) / 2.0) * f + (n - 1) / 2.0
        valids.append((c >= -0.5) & (c <= n - 0.5))
        grids.append(torch.clamp(c, 0, n - 1))
    valid = (valids[0][:, None, None] & valids[1][None, :, None]
             & valids[2][None, None, :])[None, ..., None]
    gy, gx, gz = grids
    img = _lerp_axis(_lerp_axis(_lerp_axis(images, 1, gy), 2, gx), 3, gz)
    iy, ix, iz = (torch.round(g).long() for g in grids)
    msk = masks.index_select(1, iy).index_select(2, ix).index_select(3, iz)
    return img * valid.to(img.dtype), msk * valid.to(msk.dtype)


def noise_draw(shape, sigma: float = 0.1, clip: float = 0.2, generator=None,
               device=None) -> torch.Tensor:
    """RandomNoise's additive noise: clip(sigma N(0, 1), -clip, clip)."""
    z = torch.randn(shape, generator=generator, device=device)
    return torch.clamp(sigma * z, -clip, clip)
