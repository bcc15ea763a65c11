"""The vanilla U-Net, the Polyformer's host network (``--net
unet-scratch``). Counterpart of ``segtran_tpu/models/unet2d.py``
(reference code/networks/unet2d/unet_model.py, unet_parts.py): DoubleConv
(3x3 conv + BatchNorm + ReLU, twice), Down (2x2 max pool + DoubleConv),
Up (bilinear align-corners 2x upsample, centre pad to the skip, concat,
DoubleConv with mid = half the concatenated channels), the 1x1 OutConv,
and with ``polyformer_mode`` the Polyformer before ``outc``.

Channels-last [B, H, W, C] like the JAX module; each conv runs on a
channels-first view. BatchNorm has flax semantics (momentum 0.9, eps
1e-5); ``bn_eval`` (``--bnopt fixstats``) keeps the running statistics in
training. With ``keep_features`` the forward keeps the features before
``outc`` in ``pre_outc_feat`` (the DA feature; the reference's
``feature_maps[-1]``). Module names follow the reference's attributes
(``inc.double_conv.0``), so JAX variables convert by the generic rules.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..adapt.polyformer import Polyformer
from ..ops.norm import BatchNorm
from ..ops.resize import max_pool_nhwc, resize_linear_align_corners


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                 conv.bias.to(dtype), padding=conv.padding)
    return y.permute(0, 2, 3, 1)


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: Optional[int] = None, bn_eval: bool = False,
                 dtype=torch.float32):
        super().__init__()
        mid = mid_channels or out_channels
        self.dtype = dtype
        self.double_conv = nn.ModuleDict({
            "0": nn.Conv2d(in_channels, mid, 3, padding=1),
            "1": BatchNorm(mid, use_running_average=bn_eval),
            "3": nn.Conv2d(mid, out_channels, 3, padding=1),
            "4": BatchNorm(out_channels, use_running_average=bn_eval)})

    def forward(self, x):
        dc, dt = self.double_conv, self.dtype
        for conv, bn in (("0", "1"), ("3", "4")):
            x = _conv(x, dc[conv], dt)
            x = F.relu(dc[bn](x.permute(0, 3, 1, 2), dt).permute(0, 2, 3, 1))
        return x


class Down(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.maxpool_conv = nn.ModuleDict(
            {"1": DoubleConv(in_channels, out_channels, **kw)})

    def forward(self, x):
        return self.maxpool_conv["1"](max_pool_nhwc(x, (2, 2)))


class Up(nn.Module):
    """Bilinear up (the only form the JAX CLIs build)."""

    def __init__(self, in_channels: int, out_channels: int, **kw):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, in_channels // 2,
                               **kw)

    def forward(self, x1, x2):
        x1 = resize_linear_align_corners(x1, (x1.shape[1] * 2,
                                              x1.shape[2] * 2))
        dh, dw = x2.shape[1] - x1.shape[1], x2.shape[2] - x1.shape[2]
        x1 = F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        return self.conv(torch.cat([x2, x1], dim=-1))


class OutConv(nn.Module):
    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)


class VanillaUNet(nn.Module):
    """x [B, H, W, n_channels] -> logits [B, H, W, num_classes] (fp32).
    ``polyformer_mode`` None, 'source' (tied Q/K) or 'target' (loose)."""

    def __init__(self, n_channels: int = 3, num_classes: int = 3,
                 polyformer_mode: Optional[str] = None,
                 num_attractors: int = 256, num_modes: int = 4,
                 bn_eval: bool = False, dtype=torch.float32):
        super().__init__()
        kw = dict(bn_eval=bn_eval, dtype=dtype)
        self.dtype = dtype
        self.polyformer_mode = polyformer_mode
        self.keep_features = False
        self.pre_outc_feat = None
        self.inc = DoubleConv(n_channels, 64, **kw)
        self.down1 = Down(64, 128, **kw)
        self.down2 = Down(128, 256, **kw)
        self.down3 = Down(256, 512, **kw)
        self.down4 = Down(512, 512, **kw)
        self.up1 = Up(1024, 256, **kw)
        self.up2 = Up(512, 128, **kw)
        self.up3 = Up(256, 64, **kw)
        self.up4 = Up(128, 64, **kw)
        if polyformer_mode:
            tie = "shared" if polyformer_mode == "source" else "loose"
            self.polyformer = Polyformer(
                64, num_attractors=num_attractors, num_modes=num_modes,
                tie_qk_scheme=tie, dtype=dtype)
        self.outc = OutConv(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        y = self.up1(x5, x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        if self.polyformer_mode:
            y = self.polyformer(y)
        self.pre_outc_feat = y if self.keep_features else None
        return _conv(y, self.outc.conv, self.dtype).float()
