"""Channels-first building blocks of the 2-D zoo (the ResNet, Res2Net and
EfficientNetV2 backbones and the baseline nets).

Each module holds its parameters in torch layout and runs in the compute
dtype its caller passes: ``Conv2d.run(x, dtype)``, ``BatchNorm`` (flax
semantics, ``ops/norm.py``) as ``bn(x, dtype)``, ``GroupNorm.run(x,
dtype)``. The nets take and return NHWC tensors as the JAX package does and
run NCHW inside (channels-last memory on the GPU); ``nchw`` / ``nhwc``
convert at those edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import BatchNorm
from ..ops.resize import pad_arg, same_pads

__all__ = ["BatchNorm", "Conv2d", "GroupNorm", "nchw", "nhwc", "bn_relu",
           "resize_nchw", "resize_nchw_align_corners", "max_pool_nchw"]


def nchw(x: torch.Tensor, dtype) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, H, W] in ``dtype`` (channels-last memory on
    the GPU)."""
    x = x.permute(0, 3, 1, 2).to(dtype)
    return x.contiguous(memory_format=torch.channels_last) if x.is_cuda else x


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` applied in the compute dtype. ``same=True`` is flax's
    ``padding='SAME'``: the pad is taken from the runtime size, its odd
    element at the end."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1, bias=True, same=False):
        super().__init__(cin, cout, k, stride=stride, padding=padding,
                         dilation=dilation, groups=groups, bias=bias)
        self.same = same

    def run(self, x: torch.Tensor, dtype) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(dtype)
        pad = self.padding
        if self.same:
            x = F.pad(x, pad_arg(same_pads(x.shape[2:], self.kernel_size,
                                           self.stride)))
            pad = 0
        return F.conv2d(x.to(dtype), self.weight.to(dtype), b, self.stride,
                        pad, self.dilation, self.groups)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on [B, C, H, W]: statistics and normalize in
    fp32, result in the compute dtype (``num_groups == C`` is the instance
    norm)."""

    def run(self, x: torch.Tensor, dtype) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.to(ct), self.num_groups, self.weight.to(ct),
                            self.bias.to(ct), self.eps).to(dtype)


def bn_relu(conv: Conv2d, bn: BatchNorm, x: torch.Tensor, dtype):
    """conv -> BatchNorm -> ReLU."""
    return F.relu(bn(conv.run(x, dtype), dtype))


def resize_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear, half-pixel centres (``ops.resize.resize_linear``) on NCHW."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=False)


def resize_nchw_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


def max_pool_nchw(x: torch.Tensor, k: int, stride: int = None,
                  pad: int = 0) -> torch.Tensor:
    """Max pool with -inf padding (flax ``reduce_window`` semantics)."""
    if pad:
        x = F.pad(x, (pad,) * 4, value=float("-inf"))
    return F.max_pool2d(x, k, stride or k)
