"""Spatial resize and pooling on channels-last tensors (NHWC / NDHWC).

``resize_linear`` is ``F.interpolate(mode='bilinear' | 'trilinear',
align_corners=False, antialias=False)``: half-pixel centres, no
antialiasing filter -- the sampling the JAX package's
``jax.image.resize(method='linear', antialias=False)`` implements.
``resize_image_linear`` is ``jax.image.resize(method='linear')`` with its
default ``antialias=True``: a shrink filters with the triangle kernel
widened by the scale (``F.interpolate(..., antialias=True)``), a growth
samples as ``resize_linear`` does (the analysis tools' resizes).
``resize_linear_align_corners`` is the same with ``align_corners=True``
(the vanilla U-Net's upsampling); ``max_pool_nhwc`` is a max pool with
VALID or explicit padding, ``max_pool_same`` one with TF-SAME padding: the
pad is split with the odd element at the end and filled with -inf.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

_MODES = {2: "bilinear", 3: "trilinear"}


def _channels_first(x):
    return x.movedim(-1, 1)


def _channels_last(x):
    return x.movedim(1, -1)


def resize_linear(x: torch.Tensor, spatial_size: Sequence[int]) -> torch.Tensor:
    """x: [B, *spatial, C] with 2 or 3 spatial dims -> [B, *spatial_size, C]."""
    spatial_size = tuple(int(s) for s in spatial_size)
    assert x.dim() == len(spatial_size) + 2, (x.shape, spatial_size)
    if tuple(x.shape[1:-1]) == spatial_size:
        return x
    y = F.interpolate(_channels_first(x), size=spatial_size,
                      mode=_MODES[len(spatial_size)], align_corners=False,
                      antialias=False)
    return _channels_last(y)


def resize_image_linear(x: torch.Tensor,
                        spatial_size: Sequence[int]) -> torch.Tensor:
    """x: [B, H, W, C] -> [B, *spatial_size, C], antialiased where it
    shrinks (``jax.image.resize(x, shape, 'linear')``)."""
    spatial_size = tuple(int(s) for s in spatial_size)
    if tuple(x.shape[1:-1]) == spatial_size:
        return x
    y = F.interpolate(_channels_first(x), size=spatial_size, mode="bilinear",
                      align_corners=False, antialias=True)
    return _channels_last(y)


def resize_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``resize_linear`` of x to the spatial size of ``like`` (both
    channels-last)."""
    return resize_linear(x, like.shape[1:-1])


def interpolate_channels_last(x: torch.Tensor, scale) -> torch.Tensor:
    """Scale-factor form of ``resize_linear``: each spatial size becomes
    ``int(size * scale)`` (torch's floor), ``scale`` one number or one per
    spatial dim."""
    n_sp = x.dim() - 2
    if isinstance(scale, (int, float)):
        scale = (scale,) * n_sp
    return resize_linear(x, tuple(int(s * f) for s, f in
                                  zip(x.shape[1:-1], scale)))


def resize_linear_align_corners(x: torch.Tensor,
                                spatial_size: Sequence[int]) -> torch.Tensor:
    """``resize_linear`` with ``align_corners=True`` sampling (src = i *
    (n_in - 1) / (n_out - 1)); x [B, *spatial, C]."""
    spatial_size = tuple(int(s) for s in spatial_size)
    assert x.dim() == len(spatial_size) + 2, (x.shape, spatial_size)
    if tuple(x.shape[1:-1]) == spatial_size:
        return x
    y = F.interpolate(_channels_first(x), size=spatial_size,
                      mode=_MODES[len(spatial_size)], align_corners=True)
    return _channels_last(y)


def avg_pool_nhwc(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Non-overlapping average pool (stride == window) of [B, *spatial, C]."""
    window = tuple(int(w) for w in window)
    pool = F.avg_pool2d if len(window) == 2 else F.avg_pool3d
    return _channels_last(pool(_channels_first(x), kernel_size=window,
                               stride=window))


def max_pool_nhwc(x: torch.Tensor, window: Sequence[int],
                  strides: Sequence[int] | None = None,
                  padding="VALID") -> torch.Tensor:
    """Max pool of [B, *spatial, C] (2 or 3 spatial dims); ``padding``
    "VALID" or (lo, hi) per spatial dim, filled with -inf."""
    window = tuple(int(w) for w in window)
    strides = tuple(int(s) for s in (strides or window))
    xc = _channels_first(x)
    if not isinstance(padding, str):
        xc = F.pad(xc, pad_arg(padding), value=float("-inf"))
    pool = F.max_pool2d if len(window) == 2 else F.max_pool3d
    return _channels_last(pool(xc, window, strides))


def same_pads(size: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]):
    """TF-SAME (lo, hi) pads per spatial dim: the output has ceil(size /
    stride) entries and the odd pad element goes to the end."""
    pads = []
    for s, k, st in zip(size, kernel, stride):
        total = max((math.ceil(s / st) - 1) * st + k - s, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_arg(pads):
    """(lo, hi) pads in spatial order -> the F.pad argument (last dim first)."""
    return tuple(v for lo_hi in reversed(pads) for v in lo_hi)


def max_pool_same(x: torch.Tensor, window: Sequence[int],
                  stride: Sequence[int]) -> torch.Tensor:
    """3D max pool with TF-SAME padding of a channels-FIRST [B, C, D, H, W]
    tensor (the I3D backbone's layout)."""
    pads = same_pads(x.shape[2:], window, stride)
    if all(lo == hi for lo, hi in pads):
        return F.max_pool3d(x, window, stride, padding=[lo for lo, _ in pads])
    x = F.pad(x, pad_arg(pads), value=float("-inf"))
    return F.max_pool3d(x, window, stride)
