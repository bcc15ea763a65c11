"""DeepLabV3 / V3+ (``--net deeplabv3`` / ``deeplabv3plus`` /
``deeplab-smp``).

Counterpart of ``segtran_tpu/models/deeplab.py`` (the reference's vendored
deeplab): a dilated ResNet backbone (output stride 8: the strides of
layers 3 and 4 become dilations, ASPP rates 12/24/36; output stride 16:
layer 4 only, rates 6/12/18), ASPP with a 1x1 branch, three atrous
branches, image pooling and a projection with dropout 0.1; the V3+ head
fuses a 48-channel projection of layer 1 (concatenated as [low, aspp]);
the V3 head is ASPP, 3x3 conv + BN + ReLU and a 1x1 classifier. Resizes
are bilinear, ``align_corners=False``.

NHWC in, fp32 NHWC logits out; runs NCHW. Module names are the JAX
scopes under the generic rule (``classifier.aspp.convs1.0``).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.attention import Dropout
from ..nn.backbones.resnet import RESNET_LAYERS, ResNetFeatures
from ..nn.convbn import BatchNorm, Conv2d, bn_relu, nchw, nhwc, resize_nchw


def _conv_bn(cin, cout, k, dilation=1, conv_idx=0):
    """torch Sequential(conv, bn, relu) as a ModuleDict keyed by index."""
    p = dilation * (k // 2)
    return nn.ModuleDict({
        str(conv_idx): Conv2d(cin, cout, k, padding=p, dilation=dilation,
                              bias=False),
        str(conv_idx + 1): BatchNorm(cout)})


def _run(seq, x, dt, conv_idx=0):
    return bn_relu(seq[str(conv_idx)], seq[str(conv_idx + 1)], x, dt)


class ASPP(nn.Module):
    def __init__(self, cin, rates: Sequence[int] = (12, 24, 36),
                 features: int = 256, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rates = tuple(rates)
        self.convs0 = _conv_bn(cin, features, 1)
        for i, r in enumerate(self.rates):
            setattr(self, f"convs{i + 1}", _conv_bn(cin, features, 3, r))
        n = len(self.rates) + 1
        setattr(self, f"convs{n}", _conv_bn(cin, features, 1, conv_idx=1))
        self.project = _conv_bn(features * (n + 1), features, 1)
        self.dropout = Dropout(0.1)

    def forward(self, x):
        dt = self.dtype
        n = len(self.rates) + 1
        res = [_run(getattr(self, f"convs{i}"), x, dt) for i in range(n)]
        gp = _run(getattr(self, f"convs{n}"), x.mean((2, 3), keepdim=True),
                  dt, conv_idx=1)
        res.append(gp.expand_as(res[0]))
        return self.dropout(_run(self.project, torch.cat(res, 1), dt))


class _V3PlusHead(nn.Module):
    """``classifier``: Sequential(conv3x3, bn, relu, conv1x1)."""

    def __init__(self, low_ch, high_ch, num_classes, rates, dtype):
        super().__init__()
        self.dtype = dtype
        self.project = _conv_bn(low_ch, 48, 1)
        self.aspp = ASPP(high_ch, rates, dtype=dtype)
        self.classifier = _conv_bn(48 + 256, 256, 3)
        self.classifier["3"] = Conv2d(256, num_classes, 1)

    def forward(self, low, out):
        dt = self.dtype
        low_proj = _run(self.project, low, dt)
        aspp = resize_nchw(self.aspp(out), low_proj.shape[2:])
        v = _run(self.classifier, torch.cat([low_proj, aspp.to(dt)], 1), dt)
        return self.classifier["3"].run(v, dt)


class _V3Head(nn.Module):
    """``classifier``: Sequential(ASPP, conv3x3, bn, relu, conv1x1)."""

    def __init__(self, high_ch, num_classes, rates, dtype):
        super().__init__()
        self.dtype = dtype
        self.classifier = _conv_bn(256, 256, 3, conv_idx=1)
        self.classifier["0"] = ASPP(high_ch, rates, dtype=dtype)
        self.classifier["4"] = Conv2d(256, num_classes, 1)

    def forward(self, out):
        dt, c = self.dtype, self.classifier
        v = _run(c, c["0"](out), dt, conv_idx=1)
        return c["4"].run(v, dt)


class _DeepLab(nn.Module):
    plus = False

    def __init__(self, num_classes: int = 2, backbone: str = "resnet50",
                 output_stride: int = 8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        dilated = ((False, True, True) if output_stride == 8
                   else (False, False, True))
        rates = (12, 24, 36) if output_stride == 8 else (6, 12, 18)
        self.backbone = ResNetFeatures(backbone, do_pool1=True,
                                       replace_stride_with_dilation=dilated,
                                       dtype=dtype)
        exp = 1 if RESNET_LAYERS[backbone][0] == "basic" else 4
        if self.plus:
            self.classifier = _V3PlusHead(64 * exp, 512 * exp, num_classes,
                                          rates, dtype)
        else:
            self.classifier = _V3Head(512 * exp, num_classes, rates, dtype)

    def forward(self, x):
        h, w = x.shape[1:3]
        feats = self.backbone.forward_nchw(nchw(x, self.dtype))
        if self.plus:
            logits = self.classifier(feats[1], feats[4])
        else:
            logits = self.classifier(feats[4])
        return nhwc(resize_nchw(logits.float(), (h, w)))


class DeepLabV3(_DeepLab):
    """deeplabv3_resnet{50,101}."""


class DeepLabV3Plus(_DeepLab):
    """deeplabv3plus_resnet{50,101}."""
    plus = True
