"""ResNet-18/34/50/101/152 feature extractor.

Counterpart of ``segtran_tpu/nn/backbones/resnet.py`` (reference
code/resnet.py, torchvision's ResNet): BasicBlock / Bottleneck with the
stride on the 3x3 conv, the 5-level pyramid of ``ext_features`` (stem
after its max pool, layer1..layer4), ``do_pool1=False`` drops the stem's
max pool (``bb_feat_upsize``: every map twice the size),
``stem_prepool_tap`` taps the stem before the pool (SMP's ResNet encoder),
and ``replace_stride_with_dilation`` moves a layer's stride into the
dilation of its 3x3 convs, the layer's first block keeping the previous
dilation (torchvision ``_make_layer``). BatchNorm momentum 0.9 in flax's
convention (torch's 0.1), eps 1e-5.

Takes NHWC, returns the pyramid NHWC in the compute dtype; runs NCHW.
Module names are the reference's (``layer3.5.downsample.0``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convbn import BatchNorm, Conv2d, max_pool_nchw, nchw, nhwc

RESNET_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


def _conv(cin, cout, k, stride=1, dilation=1):
    return Conv2d(cin, cout, k, stride, padding=dilation * (k // 2),
                  dilation=dilation, bias=False)


class _Block(nn.Module):
    def _residual(self, x, dt):
        if not hasattr(self, "downsample"):
            return x
        return self.downsample["1"](self.downsample["0"].run(x, dt), dt)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dilation=1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm(planes)
        if downsample:
            self.downsample = nn.ModuleDict({
                "0": Conv2d(inplanes, planes, 1, stride, bias=False),
                "1": BatchNorm(planes)})

    def forward(self, x):
        dt = self.dtype
        out = F.relu(self.bn1(self.conv1.run(x, dt), dt))
        out = self.bn2(self.conv2.run(out, dt), dt)
        return F.relu(out + self._residual(x, dt))


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dilation=1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            self.downsample = nn.ModuleDict({
                "0": Conv2d(inplanes, planes * 4, 1, stride, bias=False),
                "1": BatchNorm(planes * 4)})

    def forward(self, x):
        dt = self.dtype
        out = F.relu(self.bn1(self.conv1.run(x, dt), dt))
        out = F.relu(self.bn2(self.conv2.run(out, dt), dt))
        out = self.bn3(self.conv3.run(out, dt), dt)
        return F.relu(out + self._residual(x, dt))


class ResNetFeatures(nn.Module):
    """x [B, H, W, C] -> (stem[+pool], layer1, ..., layer4), NHWC."""

    def __init__(self, variant: str = "resnet50", do_pool1: bool = True,
                 stem_prepool_tap: bool = False,
                 replace_stride_with_dilation: Sequence[bool] = (False,) * 3,
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        if variant not in RESNET_LAYERS:
            raise ValueError(f"unknown ResNet variant {variant}; one of "
                             f"{sorted(RESNET_LAYERS)}")
        kind, layers = RESNET_LAYERS[variant]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.dtype = dtype
        self.do_pool1 = do_pool1
        self.stem_prepool_tap = stem_prepool_tap
        self.conv1 = Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes, dilation = 64, 1
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            stride = 1 if li == 0 else 2
            prev_dilation = dilation
            if li > 0 and replace_stride_with_dilation[li - 1]:
                dilation *= stride
                stride = 1
            mods = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                need_ds = bi == 0 and (s != 1
                                       or inplanes != planes * block.expansion)
                mods.append(block(inplanes, planes, s, need_ds,
                                  prev_dilation if bi == 0 else dilation,
                                  dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{li + 1}", nn.ModuleList(mods))

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, C, H, W] in the compute dtype -> the pyramid, NCHW."""
        dt = self.dtype
        x = F.relu(self.bn1(self.conv1.run(x, dt), dt))
        stem = x
        if self.do_pool1:
            x = max_pool_nchw(x, 3, 2, pad=1)
        feats = [stem if self.stem_prepool_tap else x]
        for li in range(1, 5):
            for blk in getattr(self, f"layer{li}"):
                x = blk(x)
            feats.append(x)
        return tuple(feats)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(nhwc(f) for f in self.forward_nchw(nchw(x, self.dtype)))
