"""PraNet (``--net pranet``): receptive-field blocks, a partial decoder
and three reverse-attention branches on a Res2Net-50-v1b backbone,
returning four lateral maps.

Counterpart of ``segtran_tpu/models/pranet.py`` (reference
code/networks/pranet/PraNet_Res2Net.py): RFB_modified, the aggregation
decoder with ``align_corners=True`` 2x upsamples whose last conv has one
channel whatever ``num_classes`` (the reference's quirk; the one-channel
map broadcasts into the reverse-attention branches), and the branches at
1/32, 1/16 and 1/8 with ``align_corners=False`` resizes.
``PraNetForTraining`` is the net the CLIs build: built with
``num_classes - 1`` channels, it returns ``lateral_map_2`` with a zero
background channel in front (reference train2d.py:1207-1214).

NHWC in, fp32 NHWC maps out; runs NCHW. Module names are the reference's
(``rfb2_1.branch1.2.conv``, ``agg1.conv_upsample1``, ``ra4_conv1``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.backbones.res2net import Res2NetFeatures
from ..nn.convbn import (BatchNorm, Conv2d, nchw, nhwc, resize_nchw,
                         resize_nchw_align_corners)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm, no activation."""

    def __init__(self, cin, cout, kernel=(1, 1), dilation=1,
                 dtype=torch.float32):
        super().__init__()
        kh, kw = kernel
        self.dtype = dtype
        pad = (dilation * (kh // 2), dilation * (kw // 2))
        self.conv = Conv2d(cin, cout, kernel, padding=pad, dilation=dilation,
                           bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(self.conv.run(x, self.dtype), self.dtype)


class RFBModified(nn.Module):
    def __init__(self, cin, f, dtype=torch.float32):
        super().__init__()
        self.branch0 = nn.ModuleList([BasicConv2d(cin, f, dtype=dtype)])
        for bi, (k, d) in enumerate(((3, 3), (5, 5), (7, 7)), start=1):
            setattr(self, f"branch{bi}", nn.ModuleList([
                BasicConv2d(cin, f, dtype=dtype),
                BasicConv2d(f, f, (1, k), dtype=dtype),
                BasicConv2d(f, f, (k, 1), dtype=dtype),
                BasicConv2d(f, f, (3, 3), dilation=d, dtype=dtype)]))
        self.conv_cat = BasicConv2d(4 * f, f, (3, 3), dtype=dtype)
        self.conv_res = BasicConv2d(cin, f, dtype=dtype)

    def forward(self, x):
        branches = []
        for bi in range(4):
            v = x
            for m in getattr(self, f"branch{bi}"):
                v = m(v)
            branches.append(v)
        return F.relu(self.conv_cat(torch.cat(branches, 1))
                      + self.conv_res(x))


def _up2(v):
    return resize_nchw_align_corners(v, (v.shape[2] * 2, v.shape[3] * 2))


class Aggregation(nn.Module):
    def __init__(self, channel, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        c = lambda cin, cout: BasicConv2d(cin, cout, (3, 3), dtype=dtype)
        self.conv_upsample1 = c(channel, channel)
        self.conv_upsample2 = c(channel, channel)
        self.conv_upsample3 = c(channel, channel)
        self.conv_upsample4 = c(channel, channel)
        self.conv_upsample5 = c(2 * channel, 2 * channel)
        self.conv_concat2 = c(2 * channel, 2 * channel)
        self.conv_concat3 = c(3 * channel, 3 * channel)
        self.conv4 = c(3 * channel, 3 * channel)
        self.conv5 = Conv2d(3 * channel, 1, 1)

    def forward(self, x1, x2, x3):
        x2_1 = self.conv_upsample1(_up2(x1)) * x2
        x3_1 = (self.conv_upsample2(_up2(_up2(x1)))
                * self.conv_upsample3(_up2(x2)) * x3)
        x2_2 = self.conv_concat2(torch.cat(
            [x2_1, self.conv_upsample4(_up2(x1))], 1))
        x3_2 = self.conv_concat3(torch.cat(
            [x3_1, self.conv_upsample5(_up2(x2_2))], 1))
        return self.conv5.run(self.conv4(x3_2), self.dtype)


# (features, kernel, relu after) of each reverse-attention branch
_RA = {4: (256, ((256, 1, False), (256, 5, True), (256, 5, True),
                 (256, 5, True))),
       3: (64, ((64, 1, False), (64, 3, True), (64, 3, True))),
       2: (64, ((64, 1, False), (64, 3, True), (64, 3, True)))}
_RA_LAST_K = {4: 1, 3: 3, 2: 3}
_FEAT_CH = {2: 512, 3: 1024, 4: 2048}


class PraNet(nn.Module):
    """x [B, H, W, 3] -> (lateral_5, lateral_4, lateral_3, lateral_2),
    each [B, H, W, num_classes] fp32 (lateral_5 one channel)."""

    def __init__(self, num_classes: int = 1, channel: int = 32,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_classes = num_classes
        self.resnet = Res2NetFeatures("res2net50", do_pool1=True, dtype=dtype)
        for lvl in (2, 3, 4):
            setattr(self, f"rfb{lvl}_1",
                    RFBModified(_FEAT_CH[lvl], channel, dtype))
        self.agg1 = Aggregation(channel, dtype)
        for lvl, (f, convs) in _RA.items():
            cin = _FEAT_CH[lvl]
            for i, (cout, k, _) in enumerate(convs):
                setattr(self, f"ra{lvl}_conv{i + 1}",
                        BasicConv2d(cin, cout, (k, k), dtype=dtype))
                cin = cout
            setattr(self, f"ra{lvl}_conv{len(convs) + 1}",
                    BasicConv2d(cin, num_classes,
                                (_RA_LAST_K[lvl],) * 2, dtype=dtype))

    def _ra_branch(self, lvl, feat, crop):
        att = 1.0 - torch.sigmoid(crop)
        v = att.repeat(1, feat.shape[1] // att.shape[1], 1, 1) * feat
        convs = _RA[lvl][1]
        for i, (_, _, act) in enumerate(convs):
            v = getattr(self, f"ra{lvl}_conv{i + 1}")(v)
            if act:
                v = F.relu(v)
        v = getattr(self, f"ra{lvl}_conv{len(convs) + 1}")(v)
        return v + crop

    def forward(self, x):
        h, w = x.shape[1:3]
        _, x1, x2, x3, x4 = self.resnet.forward_nchw(nchw(x, self.dtype))
        ra5 = self.agg1(self.rfb4_1(x4), self.rfb3_1(x3), self.rfb2_1(x2))
        full = lambda v: nhwc(resize_nchw(v.float(), (h, w)))
        out4 = self._ra_branch(4, x4, resize_nchw(ra5, x4.shape[2:]))
        out3 = self._ra_branch(3, x3, resize_nchw(out4, x3.shape[2:]))
        out2 = self._ra_branch(2, x2, resize_nchw(out3, x2.shape[2:]))
        return full(ra5), full(out4), full(out3), full(out2)


class PraNetForTraining(PraNet):
    """The CLIs' PraNet: ``num_classes`` output channels, the first a zero
    background in front of ``lateral_map_2`` (of ``num_classes - 1``)."""

    def __init__(self, num_classes: int = 2, channel: int = 32,
                 dtype=torch.float32):
        super().__init__(num_classes - 1, channel, dtype)

    def forward(self, x):
        lat2 = super().forward(x)[3]
        return torch.cat([torch.zeros_like(lat2[..., :1]), lat2], -1)
