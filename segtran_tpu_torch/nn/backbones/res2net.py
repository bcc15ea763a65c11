"""Res2Net-v1b feature extractor, the PraNet backbone.

Counterpart of ``segtran_tpu/nn/backbones/res2net.py`` (reference
code/networks/pranet/Res2Net_v1b.py): the deep 3-conv stem (3x3 s2 -> 32,
3x3 -> 32, 3x3 -> 64), the v1b shortcut (``AvgPool2d(stride,
count_include_pad=False)`` then a stride-1 1x1 conv and BatchNorm), and
``Bottle2neck``: the 1x1-compressed features split into ``scale`` chunks
of ``width = floor(planes * base_width / 64)`` that pass through a chain
of 3x3 convs with hierarchical adds ('normal' blocks) or independently
('stage' blocks, the first of each layer), the last chunk passed through
(normal) or 3x3-average-pooled with ``count_include_pad=True`` (stage).

Takes NHWC, returns the 5-level pyramid NHWC; runs NCHW. Module names are
the reference's (``layer2.0.convs.1``, ``conv1.3``, ``downsample.1``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convbn import BatchNorm, Conv2d, max_pool_nchw, nchw, nhwc

RES2NET_LAYERS = {
    "res2net50": (3, 4, 6, 3),
    "res2net101": (3, 4, 23, 3),
}


def avg_pool2d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """torch ``nn.AvgPool2d`` with floor mode on NCHW (the JAX package's
    ``avg_pool2d``: the v1b shortcut pool has kernel == stride, where ceil
    and floor agree on the even sizes PraNet takes)."""
    return F.avg_pool2d(x, kernel, stride, padding,
                        count_include_pad=count_include_pad)


class Bottle2neck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 stype="normal", base_width=26, scale=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride, self.stype, self.scale = stride, stype, scale
        self.width = width = int(math.floor(planes * (base_width / 64.0)))
        self.nums = 1 if scale == 1 else scale - 1
        self.conv1 = Conv2d(inplanes, width * scale, 1, bias=False)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride, padding=1, bias=False)
            for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(self.nums))
        self.conv3 = Conv2d(width * scale, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            # Sequential(AvgPool, conv, bn): the pool holds no parameter
            self.downsample = nn.ModuleDict({
                "1": Conv2d(inplanes, planes * 4, 1, bias=False),
                "2": BatchNorm(planes * 4)})

    def forward(self, x):
        dt, w = self.dtype, self.width
        out = F.relu(self.bn1(self.conv1.run(x, dt), dt))
        spx = torch.split(out, w, dim=1)
        pieces, sp = [], None
        for i in range(self.nums):
            sp = spx[i] if (i == 0 or self.stype == "stage") else sp + spx[i]
            sp = F.relu(self.bns[i](self.convs[i].run(sp, dt), dt))
            pieces.append(sp)
        if self.scale != 1:
            last = spx[self.nums]
            if self.stype == "stage":
                last = avg_pool2d(last, 3, self.stride, padding=1)
            pieces.append(last)
        out = self.bn3(self.conv3.run(torch.cat(pieces, 1), dt), dt)
        residual = x
        if hasattr(self, "downsample"):
            residual = avg_pool2d(x, self.stride, self.stride,
                                  count_include_pad=False)
            residual = self.downsample["2"](
                self.downsample["1"].run(residual, dt), dt)
        return F.relu(out + residual)


class Res2NetFeatures(nn.Module):
    """x [B, H, W, C] -> (stem[+pool], layer1, ..., layer4), NHWC."""

    def __init__(self, variant: str = "res2net50", do_pool1: bool = True,
                 base_width: int = 26, scale: int = 4, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.do_pool1 = do_pool1
        self.conv1 = nn.ModuleDict({
            "0": Conv2d(in_channels, 32, 3, 2, padding=1, bias=False),
            "1": BatchNorm(32),
            "3": Conv2d(32, 32, 3, 1, padding=1, bias=False),
            "4": BatchNorm(32),
            "6": Conv2d(32, 64, 3, 1, padding=1, bias=False)})
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for li, (planes, blocks) in enumerate(zip(
                (64, 128, 256, 512), RES2NET_LAYERS[variant])):
            stride = 1 if li == 0 else 2
            mods = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                need_ds = bi == 0 and (s != 1 or inplanes != planes * 4)
                mods.append(Bottle2neck(inplanes, planes, s, need_ds,
                                        "stage" if bi == 0 else "normal",
                                        base_width, scale, dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(mods))

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dt, c = self.dtype, self.conv1
        x = F.relu(c["1"](c["0"].run(x, dt), dt))
        x = F.relu(c["4"](c["3"].run(x, dt), dt))
        x = F.relu(self.bn1(c["6"].run(x, dt), dt))
        if self.do_pool1:
            x = max_pool_nchw(x, 3, 2, pad=1)
        feats = [x]
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = blk(x)
            feats.append(x)
        return tuple(feats)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(nhwc(f) for f in self.forward_nchw(nchw(x, self.dtype)))
