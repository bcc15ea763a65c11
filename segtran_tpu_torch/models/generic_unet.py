"""nnU-Net-style Generic_UNet (``--net nnunet``).

Counterpart of ``segtran_tpu/models/generic_unet.py`` (the reference's
external nnunet Generic_UNet wiring): per stage conv3x3 + instance norm +
LeakyReLU(1e-2) twice, the first with stride 2 below the top stage,
features ``min(base * 2^i, max)``; 2x2 stride-2 transposed convs up,
the skip concatenated after; a bias-free 1x1 head per decoder stage with
deep supervision (outputs full resolution first, the deepest last), else
the top one. NHWC in, fp32 NHWC logits out; runs NCHW.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import Conv2d, GroupNorm, nchw, nhwc


class ConvBlock(nn.Module):
    def __init__(self, cin, features, stride=1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(cin, features, 3, stride, padding=1)
        self.norm = GroupNorm(features, features, eps=1e-5)

    def forward(self, x):
        x = self.norm.run(self.conv.run(x, self.dtype), self.dtype)
        return F.leaky_relu(x, 0.01)


class GenericUNet(nn.Module):
    def __init__(self, num_classes: int = 2, base_features: int = 32,
                 num_stages: int = 5, max_features: int = 512,
                 deep_supervision: bool = True, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_stages = num_stages
        self.deep_supervision = deep_supervision
        feats = [min(base_features * 2 ** i, max_features)
                 for i in range(num_stages)]
        cin = in_channels
        for i, f in enumerate(feats):
            setattr(self, f"enc{i}_a", ConvBlock(cin, f, 1 if i == 0 else 2,
                                                 dtype))
            setattr(self, f"enc{i}_b", ConvBlock(f, f, 1, dtype))
            cin = f
        for i in range(num_stages - 2, -1, -1):
            setattr(self, f"up{i}", nn.ConvTranspose2d(cin, feats[i], 2, 2,
                                                       bias=False))
            setattr(self, f"dec{i}_a", ConvBlock(2 * feats[i], feats[i], 1,
                                                 dtype))
            setattr(self, f"dec{i}_b", ConvBlock(feats[i], feats[i], 1,
                                                 dtype))
            if deep_supervision or i == 0:
                setattr(self, f"seg{i}", Conv2d(feats[i], num_classes, 1,
                                                bias=False))
            cin = feats[i]

    def forward(self, x):
        dt = self.dtype
        x = nchw(x, dt)
        skips = []
        for i in range(self.num_stages):
            x = getattr(self, f"enc{i}_b")(getattr(self, f"enc{i}_a")(x))
            skips.append(x)
        outputs = []
        for i in range(self.num_stages - 2, -1, -1):
            up = getattr(self, f"up{i}")
            x = F.conv_transpose2d(x, up.weight.to(dt), stride=2)
            x = torch.cat([x, skips[i]], 1)
            x = getattr(self, f"dec{i}_b")(getattr(self, f"dec{i}_a")(x))
            if self.deep_supervision or i == 0:
                outputs.append(nhwc(getattr(self, f"seg{i}").run(x, dt)
                                    .float()))
        outputs = outputs[::-1]
        return tuple(outputs) if self.deep_supervision else outputs[0]
