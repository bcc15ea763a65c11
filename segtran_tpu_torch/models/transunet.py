"""TransUNet (``--net transunet``): a ResNetV2-hybrid ViT encoder and the
cascaded upsampler with skips.

Counterpart of ``segtran_tpu/models/transunet.py`` (reference
code/networks/transunet/vit_seg_modeling.py and
vit_seg_modeling_resnet_skip.py), R50-ViT-B/16: the hybrid stem
(weight-standardised convs, ``StdConv``: per output channel, population
variance, eps 1e-5; the root k7 s2 + GroupNorm(32) + ReLU, a VALID 3x3
stride-2 max pool, three stages of ``PreActBottleneck`` (3, 4, 9) whose
projection shortcut is normalised by a per-channel GroupNorm; GroupNorm
eps 1e-6), the skips of the first two stages zero-padded bottom-right to
in_size/4/(i+1) (the reference's quirk: the unpadded pool shrinks them),
a 1x1 patch embedding (patch grid = input/16), learned position
embeddings, the 12-layer ViT (``nn/vit.py``), conv_more, four decoder
blocks (align-corners 2x upsample, skip, 2x conv3x3 + BN + ReLU) and a
3x3 head. The input must be square (as in JAX) and its size fixed at
construction: the position embeddings have one row per patch.

NHWC in, fp32 NHWC logits out; runs NCHW outside the ViT.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import Dropout
from ..nn.convbn import (BatchNorm, Conv2d, GroupNorm, bn_relu, nchw, nhwc,
                         resize_nchw, resize_nchw_align_corners)
from ..nn.vit import ViTEncoder


class StdConv(nn.Conv2d):
    """Weight-standardised conv (reference StdConv2d)."""

    def run(self, x, dtype):
        w = self.weight
        m = w.mean((1, 2, 3), keepdim=True)
        v = w.var((1, 2, 3), keepdim=True, unbiased=False)
        w = (w - m) / torch.sqrt(v + 1e-5)
        b = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), w.to(dtype), b, self.stride,
                        self.padding)


def _gn(groups, ch):
    return GroupNorm(groups, ch, eps=1e-6)


class PreActBottleneck(nn.Module):
    """conv -> GN -> ReLU (not pre-activation), post-add ReLU."""

    def __init__(self, cin, cout, cmid, stride=1, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if stride != 1 or cin != cout:
            self.downsample = StdConv(cin, cout, 1, stride, bias=False)
            self.gn_proj = _gn(cout, cout)
        self.conv1 = StdConv(cin, cmid, 1, bias=False)
        self.gn1 = _gn(32, cmid)
        self.conv2 = StdConv(cmid, cmid, 3, stride, padding=1, bias=False)
        self.gn2 = _gn(32, cmid)
        self.conv3 = StdConv(cmid, cout, 1, bias=False)
        self.gn3 = _gn(32, cout)

    def forward(self, x):
        dt = self.dtype
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj.run(self.downsample.run(x, dt), dt)
        y = F.relu(self.gn1.run(self.conv1.run(x, dt), dt))
        y = F.relu(self.gn2.run(self.conv2.run(y, dt), dt))
        y = self.gn3.run(self.conv3.run(y, dt), dt)
        return F.relu(residual + y)


class ResNetV2(nn.Module):
    """x [B, C, H, W] -> (the stage-3 map, the skips deepest first)."""

    def __init__(self, block_units: Sequence[int] = (3, 4, 9),
                 width_factor: int = 1, in_channels: int = 3,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        width = int(64 * width_factor)
        self.block_units = tuple(block_units)
        self.root_conv = StdConv(in_channels, width, 7, 2, padding=3,
                                 bias=False)
        self.root_gn = _gn(32, width)
        cin = width
        for bi, (units, cout, cmid) in enumerate(zip(
                self.block_units, (width * 4, width * 8, width * 16),
                (width, width * 2, width * 4))):
            for ui in range(units):
                setattr(self, f"body_block{bi + 1}_unit{ui + 1}",
                        PreActBottleneck(cin, cout, cmid,
                                         2 if (ui == 0 and bi > 0) else 1,
                                         dtype))
                cin = cout
        self.out_channels = cin

    def forward(self, x):
        dt = self.dtype
        in_size = x.shape[2]
        x = F.relu(self.root_gn.run(self.root_conv.run(x, dt), dt))
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        for bi, units in enumerate(self.block_units):
            for ui in range(units):
                x = getattr(self, f"body_block{bi + 1}_unit{ui + 1}")(x)
            if bi < len(self.block_units) - 1:
                right = in_size // 4 // (bi + 1)
                pad_h, pad_w = right - x.shape[2], right - x.shape[3]
                assert 0 <= pad_h < 3 and 0 <= pad_w < 3, \
                    f"skip {tuple(x.shape)} should be {right}"
                features.append(F.pad(x, (0, pad_w, 0, pad_h)))
        return x, features[::-1]


def _conv_bn(cin, cout):
    """Conv2dReLU: Sequential(conv3x3 without bias, BatchNorm, ReLU)."""
    return nn.ModuleDict({"0": Conv2d(cin, cout, 3, padding=1, bias=False),
                          "1": BatchNorm(cout)})


class DecoderBlock(nn.Module):
    def __init__(self, cin, skip_ch, features, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv_bn(cin + skip_ch, features)
        self.conv2 = _conv_bn(features, features)

    def forward(self, x, skip=None):
        dt = self.dtype
        x = resize_nchw_align_corners(x, (x.shape[2] * 2, x.shape[3] * 2))
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], 1)
        x = bn_relu(self.conv1["0"], self.conv1["1"], x, dt)
        return bn_relu(self.conv2["0"], self.conv2["1"], x, dt)


class TransUNet(nn.Module):
    """``img_size``: the (square) input side."""

    def __init__(self, num_classes: int = 2, img_size: int = 288,
                 hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16),
                 n_skip: int = 3,
                 resnet_units: Sequence[int] = (3, 4, 9),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden_dim = hidden_dim
        self.n_skip = n_skip
        self.hybrid_model = ResNetV2(resnet_units, dtype=dtype)
        self.patch_embeddings = Conv2d(self.hybrid_model.out_channels,
                                       hidden_dim, 1)
        grid = int(img_size) // 16
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid, hidden_dim))
        self.dropout = Dropout(0.1)
        self.encoder = ViTEncoder(hidden_dim, num_layers, num_heads, mlp_dim,
                                  dtype=dtype)
        self.conv_more = _conv_bn(hidden_dim, 512)
        skips = (512, 256, 64, 16)
        cin, blocks = 512, []
        for i, ch in enumerate(decoder_channels):
            blocks.append(DecoderBlock(cin, skips[i] if i < n_skip else 0,
                                       ch, dtype))
            cin = ch
        self.blocks = nn.ModuleList(blocks)
        self.segmentation_head = nn.ModuleDict(
            {"0": Conv2d(cin, num_classes, 3, padding=1)})

    def forward(self, x):
        dt = self.dtype
        b, h, w = x.shape[:3]
        tokens, features = self.hybrid_model(nchw(x, dt))
        gh, gw = tokens.shape[2:]
        t = self.patch_embeddings.run(tokens, dt)
        t = t.flatten(2).transpose(1, 2)
        t = self.dropout(t + self.position_embeddings.to(dt))
        t = self.encoder(t)
        feat = t.transpose(1, 2).reshape(b, self.hidden_dim, gh, gw)
        feat = bn_relu(self.conv_more["0"], self.conv_more["1"], feat, dt)
        for i, blk in enumerate(self.blocks):
            feat = blk(feat, features[i] if i < self.n_skip else None)
        logits = self.segmentation_head["0"].run(feat, dt)
        return nhwc(resize_nchw(logits, (h, w)).float())
