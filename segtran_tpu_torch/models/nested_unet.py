"""UNet++ (``--net nestedunet``).

Counterpart of ``segtran_tpu/models/nested_unet.py`` (reference
code/networks/nested_unet.py): VGG blocks (conv3x3 + BN + ReLU, twice)
over the nested dense skip grid, 2x2 max pools down and bilinear
``align_corners=True`` 2x upsamples, a 1x1 head ``final``; with
``deep_supervision`` (which no CLI builds) four heads ``final1..4`` on
nodes (0, 1..4), a list of logits. NHWC in, fp32 NHWC logits out; runs
NCHW. Module names are the reference's (``conv1_2.bn1``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.convbn import (BatchNorm, Conv2d, bn_relu, max_pool_nchw, nchw,
                         nhwc, resize_nchw_align_corners)

NB = (32, 64, 128, 256, 512)


class VGGBlock(nn.Module):
    def __init__(self, cin, mid, out, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(cin, mid, 3, padding=1)
        self.bn1 = BatchNorm(mid)
        self.conv2 = Conv2d(mid, out, 3, padding=1)
        self.bn2 = BatchNorm(out)

    def forward(self, x):
        x = bn_relu(self.conv1, self.bn1, x, self.dtype)
        return bn_relu(self.conv2, self.bn2, x, self.dtype)


def _in_ch(i, j, input_channels):
    """Input width of node (i, j): j same-level nodes and the upsampled
    node (i + 1, j - 1), or the pooled node (i - 1, 0) for j == 0."""
    if j == 0:
        return input_channels if i == 0 else NB[i - 1]
    return NB[i] * j + NB[i + 1]


class NestedUNet(nn.Module):
    def __init__(self, num_classes: int, input_channels: int = 3,
                 deep_supervision: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.deep_supervision = deep_supervision
        for i in range(5):
            for j in range(5 - i):
                setattr(self, f"conv{i}_{j}",
                        VGGBlock(_in_ch(i, j, input_channels), NB[i], NB[i],
                                 dtype))
        if deep_supervision:
            for i in range(1, 5):
                setattr(self, f"final{i}", Conv2d(NB[0], num_classes, 1))
        else:
            self.final = Conv2d(NB[0], num_classes, 1)

    def forward(self, x):
        dt = self.dtype
        up = lambda v: resize_nchw_align_corners(
            v, (v.shape[2] * 2, v.shape[3] * 2))
        node = {}
        for d in range(5):             # the diagonal of nodes i + j == d
            for i in range(d, -1, -1):
                j = d - i
                blk = getattr(self, f"conv{i}_{j}")
                if j == 0:
                    src = nchw(x, dt) if i == 0 else max_pool_nchw(
                        node[i - 1, 0], 2)
                else:
                    src = torch.cat([node[i, k] for k in range(j)]
                                    + [up(node[i + 1, j - 1])], 1)
                node[i, j] = blk(src)
        if self.deep_supervision:
            return [nhwc(getattr(self, f"final{j}").run(node[0, j], dt)
                         .float()) for j in range(1, 5)]
        return nhwc(self.final.run(node[0, 4], dt).float())
