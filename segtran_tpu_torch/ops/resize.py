"""Spatial resize and pooling on channels-last (NHWC) tensors.

``resize_linear`` is ``F.interpolate(mode='bilinear', align_corners=False,
antialias=False)``: half-pixel centres, no antialiasing filter -- the
sampling the JAX package's ``jax.image.resize(method='linear',
antialias=False)`` implements.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def resize_linear(x: torch.Tensor, spatial_size: Sequence[int]) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, *spatial_size, C]."""
    spatial_size = tuple(int(s) for s in spatial_size)
    assert x.dim() == 4 and len(spatial_size) == 2, (x.shape, spatial_size)
    if tuple(x.shape[1:3]) == spatial_size:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=spatial_size,
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)


def avg_pool_nhwc(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Non-overlapping average pool (stride == window) of [B, H, W, C]."""
    window = tuple(int(w) for w in window)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel_size=window, stride=window)
    return y.permute(0, 2, 3, 1)
