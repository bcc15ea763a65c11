"""UNet 3+ (``--net unet3plus``): full-scale skip connections.

Counterpart of ``segtran_tpu/models/unet_3plus.py`` (reference
code/networks/unet_3plus/unet_3plus.py): a 5-level VGG encoder (conv3x3 +
BN + ReLU, twice), and per decoder level every scale mapped to 64 channels
by conv3x3 + BN + ReLU -- encoder levels above max-pooled down, decoder
levels and the bottleneck below resized bilinearly (``align_corners=
False``) -- concatenated (320) and fused by conv3x3 + BN + ReLU; a 3x3
head. NHWC in, fp32 NHWC logits out; runs NCHW. Module names are the
reference's (``h1_PT_hd4_conv``, ``conv4d_1``, ``bn4d_1``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.convbn import (BatchNorm, Conv2d, bn_relu, max_pool_nchw, nchw,
                         nhwc, resize_nchw)

FILTERS = (64, 128, 256, 512, 1024)


class UnetConv2(nn.Module):
    def __init__(self, cin, out, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(cin, out, 3, padding=1)
        self.bn1 = BatchNorm(out)
        self.conv2 = Conv2d(out, out, 3, padding=1)
        self.bn2 = BatchNorm(out)

    def forward(self, x):
        x = bn_relu(self.conv1, self.bn1, x, self.dtype)
        return bn_relu(self.conv2, self.bn2, x, self.dtype)


def _branch_name(s, d):
    if s < d:
        return f"h{s + 1}_PT_hd{d + 1}"
    if s == d:
        return f"h{s + 1}_Cat_hd{d + 1}"
    return f"hd{s + 1}_UT_hd{d + 1}"


class UNet3Plus(nn.Module):
    def __init__(self, num_classes: int = 2, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cat_ch, up_ch = FILTERS[0], FILTERS[0] * 5
        cin = in_channels
        for i, f in enumerate(FILTERS):
            setattr(self, f"conv{i + 1}", UnetConv2(cin, f, dtype))
            cin = f
        for d in range(3, -1, -1):
            for s in range(5):
                src_ch = FILTERS[s] if s <= d or s == 4 else up_ch
                name = _branch_name(s, d)
                setattr(self, f"{name}_conv",
                        Conv2d(src_ch, cat_ch, 3, padding=1))
                setattr(self, f"{name}_bn", BatchNorm(cat_ch))
            setattr(self, f"conv{d + 1}d_1", Conv2d(up_ch, up_ch, 3,
                                                    padding=1))
            setattr(self, f"bn{d + 1}d_1", BatchNorm(up_ch))
        self.outconv1 = Conv2d(up_ch, num_classes, 3, padding=1)

    def forward(self, x):
        dt = self.dtype
        h = []
        v = nchw(x, dt)
        for i in range(5):
            if i:
                v = max_pool_nchw(v, 2)
            v = getattr(self, f"conv{i + 1}")(v)
            h.append(v)
        hd = {4: h[4]}
        for d in range(3, -1, -1):
            parts = []
            for s in range(5):
                if s < d:
                    src = max_pool_nchw(h[s], 2 ** (d - s))
                elif s == d:
                    src = h[s]
                else:
                    src = resize_nchw(hd[s], h[d].shape[2:])
                name = _branch_name(s, d)
                parts.append(bn_relu(getattr(self, f"{name}_conv"),
                                     getattr(self, f"{name}_bn"), src, dt))
            hd[d] = bn_relu(getattr(self, f"conv{d + 1}d_1"),
                            getattr(self, f"bn{d + 1}d_1"),
                            torch.cat(parts, 1), dt)
        return nhwc(self.outconv1.run(hd[0], dt).float())
