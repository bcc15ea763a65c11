"""EfficientNetV2-S/M/L feature extractor.

Counterpart of ``segtran_tpu/nn/backbones/efficientnetv2.py`` (the
reference's timm ``tf_efficientnetv2_*`` ``features_only`` backbones):
Fused-MBConv in the early stages, MBConv with SE in the later ones, flax's
SAME padding (from the runtime size, the odd pad element at the end),
BatchNorm eps 1e-3 / momentum 0.99 (flax's convention), SiLU. The taps
are the last activation before each downsampling block plus the last
block's output, five in all (timm's ``features_only``).

Takes NHWC, returns the taps NHWC in the compute dtype; runs NCHW. Module
names are the JAX scopes (``s3_b0.conv_pw``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..convbn import BatchNorm, Conv2d, nchw, nhwc

# (block, repeats, kernel, stride, expand, out_ch, se_ratio)
V2_CONFIGS = {
    "effv2s": (
        ("fused", 2, 3, 1, 1, 24, 0.0),
        ("fused", 4, 3, 2, 4, 48, 0.0),
        ("fused", 4, 3, 2, 4, 64, 0.0),
        ("mb", 6, 3, 2, 4, 128, 0.25),
        ("mb", 9, 3, 1, 6, 160, 0.25),
        ("mb", 15, 3, 2, 6, 256, 0.25),
    ),
    "effv2m": (
        ("fused", 3, 3, 1, 1, 24, 0.0),
        ("fused", 5, 3, 2, 4, 48, 0.0),
        ("fused", 5, 3, 2, 4, 80, 0.0),
        ("mb", 7, 3, 2, 4, 160, 0.25),
        ("mb", 14, 3, 1, 6, 176, 0.25),
        ("mb", 18, 3, 2, 6, 304, 0.25),
        ("mb", 5, 3, 1, 6, 512, 0.25),
    ),
    "effv2l": (
        ("fused", 4, 3, 1, 1, 32, 0.0),
        ("fused", 7, 3, 2, 4, 64, 0.0),
        ("fused", 7, 3, 2, 4, 96, 0.0),
        ("mb", 10, 3, 2, 4, 192, 0.25),
        ("mb", 19, 3, 1, 6, 224, 0.25),
        ("mb", 25, 3, 2, 6, 384, 0.25),
        ("mb", 7, 3, 1, 6, 640, 0.25),
    ),
}
V2_STEM = {"effv2s": 24, "effv2m": 24, "effv2l": 32}


def _bn(c):
    return BatchNorm(c, eps=1e-3, momentum=0.99)


class V2Block(nn.Module):
    def __init__(self, kind, in_ch, out_ch, kernel, stride, expand, se_ratio,
                 dtype=torch.float32):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.residual = stride == 1 and in_ch == out_ch
        exp = in_ch * expand
        k = kernel
        if kind == "fused":
            if expand != 1:
                self.conv_exp = Conv2d(in_ch, exp, k, stride, bias=False,
                                       same=True)
                self.bn1 = _bn(exp)
                self.conv_pwl = Conv2d(exp, out_ch, 1, bias=False)
                self.bn2 = _bn(out_ch)
            else:
                self.conv = Conv2d(in_ch, out_ch, k, stride, bias=False,
                                   same=True)
                self.bn1 = _bn(out_ch)
        else:
            self.conv_pw = Conv2d(in_ch, exp, 1, bias=False)
            self.bn1 = _bn(exp)
            self.conv_dw = Conv2d(exp, exp, k, stride, groups=exp, bias=False,
                                  same=True)
            self.bn2 = _bn(exp)
            if se_ratio > 0:
                nsq = max(1, int(in_ch * se_ratio))
                self.se_reduce = Conv2d(exp, nsq, 1)
                self.se_expand = Conv2d(nsq, exp, 1)
            self.conv_pwl = Conv2d(exp, out_ch, 1, bias=False)
            self.bn3 = _bn(out_ch)

    def forward(self, x):
        dt = self.dtype
        inputs = x
        if self.kind == "fused":
            if hasattr(self, "conv_exp"):
                x = F.silu(self.bn1(self.conv_exp.run(x, dt), dt))
                x = self.bn2(self.conv_pwl.run(x, dt), dt)
            else:
                x = F.silu(self.bn1(self.conv.run(x, dt), dt))
        else:
            x = F.silu(self.bn1(self.conv_pw.run(x, dt), dt))
            x = F.silu(self.bn2(self.conv_dw.run(x, dt), dt))
            if hasattr(self, "se_reduce"):
                se = F.silu(self.se_reduce.run(x.mean((2, 3), keepdim=True),
                                               dt))
                x = torch.sigmoid(self.se_expand.run(se, dt)) * x
            x = self.bn3(self.conv_pwl.run(x, dt), dt)
        return x + inputs if self.residual else x


class EfficientNetV2Features(nn.Module):
    """x [B, H, W, C] -> 5 NHWC taps."""

    def __init__(self, variant: str = "effv2m", stem_stride: int = 2,
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        stem = V2_STEM[variant]
        self.conv_stem = Conv2d(in_channels, stem, 3, stem_stride, bias=False,
                                same=True)
        self.bn_stem = _bn(stem)
        self.taps_before = []          # block names whose input is a tap
        in_ch = stem
        for si, (kind, r, k, s, e, oc, se) in enumerate(V2_CONFIGS[variant]):
            for j in range(r):
                stride = s if j == 0 else 1
                name = f"s{si}_b{j}"
                if stride > 1:
                    self.taps_before.append(name)
                setattr(self, name, V2Block(kind, in_ch if j == 0 else oc,
                                            oc, k, stride, e, se, dtype))
                in_ch = oc
        self.blocks = [n for n, _ in self.named_children()
                       if n.startswith("s")]

    def forward_nchw(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dt = self.dtype
        x = F.silu(self.bn_stem(self.conv_stem.run(x, dt), dt))
        taps = []
        for name in self.blocks:
            if name in self.taps_before:
                taps.append(x)         # the last activation before the stride
            x = getattr(self, name)(x)
        taps.append(x)
        if len(taps) > 5:
            taps = taps[:4] + [taps[-1]]
        return tuple(taps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(nhwc(f) for f in self.forward_nchw(nchw(x, self.dtype)))
