"""Attention U-Net and R2AttU-Net (``--net attunet`` / ``r2attunet``).

Counterpart of ``segtran_tpu/models/att_unet.py`` (reference
code/networks/att_unet.py): conv_block (conv3x3 + BN + ReLU, twice),
up_conv (nearest 2x upsample + conv3x3 + BN + ReLU), Recurrent_block
(``t`` passes of ONE conv and BatchNorm over x + x1), RRCNN_block (1x1
conv, two recurrent blocks, residual), Attention_block (additive gate,
sigmoid psi). NHWC in, fp32 NHWC logits out; runs NCHW. Module names are
the reference's (``Att5.W_g.0``, ``Conv3.RCNN.1.conv.0``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import (BatchNorm, Conv2d, bn_relu, max_pool_nchw, nchw,
                         nhwc)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.ModuleDict({"0": Conv2d(cin, cout, 3, padding=1),
                                   "1": BatchNorm(cout),
                                   "3": Conv2d(cout, cout, 3, padding=1),
                                   "4": BatchNorm(cout)})

    def forward(self, x):
        c, dt = self.conv, self.dtype
        return bn_relu(c["3"], c["4"], bn_relu(c["0"], c["1"], x, dt), dt)


class UpConv(nn.Module):
    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.up = nn.ModuleDict({"1": Conv2d(cin, cout, 3, padding=1),
                                 "2": BatchNorm(cout)})

    def forward(self, x):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        return bn_relu(self.up["1"], self.up["2"], x, self.dtype)


class RecurrentBlock(nn.Module):
    def __init__(self, ch, t=2, dtype=torch.float32):
        super().__init__()
        self.dtype, self.t = dtype, t
        self.conv = nn.ModuleDict({"0": Conv2d(ch, ch, 3, padding=1),
                                   "1": BatchNorm(ch)})

    def forward(self, x):
        conv, bn, dt = self.conv["0"], self.conv["1"], self.dtype
        x1 = None
        for i in range(self.t):
            if i == 0:
                x1 = bn_relu(conv, bn, x, dt)
            x1 = bn_relu(conv, bn, x + x1, dt)
        return x1


class RRCNNBlock(nn.Module):
    def __init__(self, cin, cout, t=2, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_1x1 = Conv2d(cin, cout, 1)
        self.RCNN = nn.ModuleList([RecurrentBlock(cout, t, dtype),
                                   RecurrentBlock(cout, t, dtype)])

    def forward(self, x):
        x = self.Conv_1x1.run(x, self.dtype)
        return x + self.RCNN[1](self.RCNN[0](x))


class AttentionBlock(nn.Module):
    def __init__(self, f_g, f_l, f_int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.W_g = nn.ModuleDict({"0": Conv2d(f_g, f_int, 1),
                                  "1": BatchNorm(f_int)})
        self.W_x = nn.ModuleDict({"0": Conv2d(f_l, f_int, 1),
                                  "1": BatchNorm(f_int)})
        self.psi = nn.ModuleDict({"0": Conv2d(f_int, 1, 1),
                                  "1": BatchNorm(1)})

    def forward(self, g, x):
        dt = self.dtype
        g1 = self.W_g["1"](self.W_g["0"].run(g, dt), dt)
        x1 = self.W_x["1"](self.W_x["0"].run(x, dt), dt)
        psi = self.psi["1"](self.psi["0"].run(F.relu(g1 + x1), dt), dt)
        return x * torch.sigmoid(psi)


class AttUNet(nn.Module):
    """AttU_Net; ``recurrent=True`` R2AttU_Net (JAX's attention-free
    variants, which no CLI builds, are not ported)."""

    def __init__(self, num_classes: int = 1, recurrent: bool = False,
                 t: int = 2, in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        block = ((lambda i, o: RRCNNBlock(i, o, t, dtype)) if recurrent
                 else (lambda i, o: ConvBlock(i, o, dtype)))
        widths = (64, 128, 256, 512, 1024)
        cin = in_channels
        for i, w in enumerate(widths):
            setattr(self, f"Conv{i + 1}", block(cin, w))
            cin = w
        for lvl in (5, 4, 3, 2):
            out = widths[lvl - 2]
            setattr(self, f"Up{lvl}", UpConv(widths[lvl - 1], out, dtype))
            setattr(self, f"Att{lvl}", AttentionBlock(out, out, out // 2,
                                                      dtype))
            setattr(self, f"Up_conv{lvl}", block(2 * out, out))
        self.Conv_1x1 = Conv2d(64, num_classes, 1)

    def forward(self, x):
        dt = self.dtype
        xs = [self.Conv1(nchw(x, dt))]
        for i in range(2, 6):
            xs.append(getattr(self, f"Conv{i}")(max_pool_nchw(xs[-1], 2)))
        d = xs[-1]
        for lvl in (5, 4, 3, 2):
            d = getattr(self, f"Up{lvl}")(d)
            skip = getattr(self, f"Att{lvl}")(d, xs[lvl - 2])
            d = getattr(self, f"Up_conv{lvl}")(torch.cat([skip, d], 1))
        return nhwc(self.Conv_1x1.run(d, dt).float())
