"""U-Net with a ResNet or EfficientNet encoder (``--net unet`` /
``unet-smp``).

Counterpart of ``segtran_tpu/models/unet_smp.py`` (the reference's
vendored segmentation_models_pytorch Unet): the encoder's 5-level pyramid
feeds SMP's UnetDecoder -- per stage a nearest 2x upsample, the skip
concatenated (resized bilinearly only where its size differs), then twice
conv3x3 + BatchNorm + ReLU -- and a 3x3 segmentation head; the logits are
resized to the input where their size differs. The ResNet encoder taps the
stem before its max pool (SMP's ResNetEncoder), the EfficientNet one the
port's ``EfficientNetFeatures`` endpoints (stem stride 2).

NHWC in, fp32 NHWC logits out; runs NCHW.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.backbones.efficientnet import EfficientNetFeatures
from ..nn.backbones.resnet import ResNetFeatures
from ..nn.convbn import BatchNorm, Conv2d, bn_relu, nchw, nhwc, resize_nchw
from ..configs.base import BACKBONE_FEAT_DIMS


def encoder_channels(encoder: str):
    """The pyramid's widths: SMP's ResNet taps (stem 64, then the layers)
    or the EfficientNet endpoints."""
    if encoder.startswith("eff-"):
        return BACKBONE_FEAT_DIMS[encoder]
    from ..nn.backbones.resnet import RESNET_LAYERS
    exp = 1 if RESNET_LAYERS[encoder][0] == "basic" else 4
    return (64,) + tuple(p * exp for p in (64, 128, 256, 512))


class DecoderBlock(nn.Module):
    """SMP DecoderBlock, attention_type None."""

    def __init__(self, cin, skip_ch, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(cin + skip_ch, features, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)

    def forward(self, x, skip=None):
        dt = self.dtype
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        if skip is not None:
            if skip.shape[2:] != x.shape[2:]:
                skip = resize_nchw(skip, x.shape[2:])
            x = torch.cat([x, skip.to(x.dtype)], 1)
        x = bn_relu(self.conv1, self.bn1, x, dt)
        return bn_relu(self.conv2, self.bn2, x, dt)


class UnetSMP(nn.Module):
    def __init__(self, num_classes: int = 2, encoder: str = "eff-b4",
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if encoder.startswith("eff-"):
            self.encoder = EfficientNetFeatures(encoder, stem_stride=2,
                                                dtype=dtype)
        else:
            self.encoder = ResNetFeatures(encoder, do_pool1=True,
                                          stem_prepool_tap=True, dtype=dtype)
        enc = encoder_channels(encoder)
        skips = list(enc[:-1])[::-1] + [0]
        cin = enc[-1]
        blocks = []
        for i, ch in enumerate(decoder_channels):
            blocks.append(DecoderBlock(cin, skips[i] if i < len(skips) else 0,
                                       ch, dtype))
            cin = ch
        self.decoder = nn.ModuleList(blocks)
        self.segmentation_head = Conv2d(cin, num_classes, 3, padding=1)

    def forward(self, x):
        dt = self.dtype
        h, w = x.shape[1:3]
        if isinstance(self.encoder, ResNetFeatures):
            feats = self.encoder.forward_nchw(nchw(x, dt))
        else:
            feats = tuple(nchw(f, dt) for f in self.encoder(x))
        v = feats[-1]
        skips = list(feats[:-1])[::-1]
        for i, blk in enumerate(self.decoder):
            v = blk(v, skips[i] if i < len(skips) else None)
        logits = self.segmentation_head.run(v, dt)
        return nhwc(resize_nchw(logits, (h, w)).float())
