"""Deformable U-Net (``--net dunet``).

Counterpart of ``segtran_tpu/models/dunet.py`` (reference
code/networks/deformable_unet/deform_unet.py DUNetV1V2): a U-Net at a
quarter of the widths whose down1/down2 and up3/up4 double-convs are
deformable (``ops/deform_conv.py``, wired with ``padding=0`` as the
reference wires them), bilinear ``align_corners=True`` upsamples centre-
padded to the skip, and the input concatenated before the 1x1 head. NHWC
in, fp32 NHWC logits out. Module names are the reference's
(``down1.conv.0.p_conv``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import BatchNorm, Conv2d, max_pool_nchw, nchw, nhwc
from ..ops.deform_conv import DeformConv2d
from ..ops.resize import resize_linear_align_corners


class DoubleConv(nn.Module):
    """NHWC in and out."""

    def __init__(self, cin, out_ch, deform=False, dtype=torch.float32):
        super().__init__()
        self.dtype, self.deform = dtype, deform
        convs = {}
        for i in range(2):
            c = cin if i == 0 else out_ch
            convs[str(3 * i)] = (DeformConv2d(c, out_ch, 3, padding=0,
                                              dtype=dtype) if deform
                                 else Conv2d(c, out_ch, 3, padding=1))
            convs[str(3 * i + 1)] = BatchNorm(out_ch)
        self.conv = nn.ModuleDict(convs)

    def forward(self, x):
        dt = self.dtype
        for i in range(2):
            conv, bn = self.conv[str(3 * i)], self.conv[str(3 * i + 1)]
            if self.deform:
                x = nchw(conv(x), dt)
            else:
                x = conv.run(nchw(x, dt), dt)
            x = nhwc(F.relu(bn(x, dt)))
        return x


class DUNetV1V2(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 2,
                 downsize_factor: int = 4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        f = lambda c: c // downsize_factor
        self.inc = DoubleConv(n_channels, f(64), dtype=dtype)
        self.down1 = DoubleConv(f(64), f(128), True, dtype)
        self.down2 = DoubleConv(f(128), f(256), True, dtype)
        self.down3 = DoubleConv(f(256), f(512), dtype=dtype)
        self.down4 = DoubleConv(f(512), f(512), dtype=dtype)
        self.up1 = DoubleConv(f(1024), f(256), dtype=dtype)
        self.up2 = DoubleConv(f(512), f(128), dtype=dtype)
        self.up3 = DoubleConv(f(256), f(64), True, dtype)
        self.up4 = DoubleConv(f(128), f(64), True, dtype)
        self.outc = Conv2d(f(64) + n_channels, n_classes, 1)

    @staticmethod
    def _pool(x):
        return nhwc(max_pool_nchw(x.permute(0, 3, 1, 2), 2))

    def _up(self, v, skip, block):
        v = resize_linear_align_corners(v, (v.shape[1] * 2, v.shape[2] * 2))
        dh, dw = skip.shape[1] - v.shape[1], skip.shape[2] - v.shape[2]
        v = F.pad(v, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return block(torch.cat([skip, v], -1))

    def forward(self, x):
        dt = self.dtype
        x1 = self.inc(x)
        x2 = self.down1(self._pool(x1))
        x3 = self.down2(self._pool(x2))
        x4 = self.down3(self._pool(x3))
        x5 = self.down4(self._pool(x4))
        y = self._up(x5, x4, self.up1)
        y = self._up(y, x3, self.up2)
        y = self._up(y, x2, self.up3)
        y = self._up(y, x1, self.up4)
        y = torch.cat([x.to(y.dtype), y], -1)
        return nhwc(self.outc.run(nchw(y, dt), dt).float())
