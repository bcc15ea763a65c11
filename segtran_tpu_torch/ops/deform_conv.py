"""Deformable convolution (v1, and v2 with ``modulation``) by gather and
bilinear sampling.

Counterpart of ``segtran_tpu/ops/deform_conv.py`` (reference
code/networks/deformable_unet/deform_conv_v2.py): a zero-initialised 3x3
``p_conv`` predicts 2 k^2 offsets per output pixel (the first k^2 rows,
the last k^2 columns), the padded input is sampled bilinearly at tap
(dr, dc) of the regular grid ``i * stride + dr`` plus its offset, the
sigmoid ``m_conv`` modulation (v2) scales the taps, and the stride-k conv
over the taps (``conv``, torch layout [O, I, k, k]) contracts them. The
reference's quirks are kept: sample coordinates and the four corners are
clamped to the image separately, so a point clamped to the bottom/right
border counts twice; with ``padding=0`` the grid sits one pixel down-right
of a centred conv.

NHWC in and out; the gathers are plain tensor indexing, so gradients reach
the input, the offsets and every weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import Conv2d


def bilinear_sample(img: torch.Tensor, y: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """img [B, H, W, C]; y, x [B, h, w, n] fp32 coordinates -> [B, h, w, n,
    C], with the reference's clamps and corner weights."""
    b, hh, ww, c = img.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    yc, xc = y.clamp(0, hh - 1), x.clamp(0, ww - 1)
    y0c, x0c = y0.clamp(0, hh - 1), x0.clamp(0, ww - 1)
    y1c, x1c = (y0 + 1).clamp(0, hh - 1), (x0 + 1).clamp(0, ww - 1)
    g_lt = (1 + (y0c - yc)) * (1 + (x0c - xc))
    g_rb = (1 - (y1c - yc)) * (1 - (x1c - xc))
    g_lb = (1 + (y0c - yc)) * (1 - (x1c - xc))
    g_rt = (1 - (y1c - yc)) * (1 + (x0c - xc))
    flat = img.reshape(b, hh * ww, c)

    def at(yy, xx):
        idx = (yy.long() * ww + xx.long()).reshape(b, -1)
        out = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return out.reshape(yy.shape + (c,))

    return (g_lt[..., None] * at(y0c, x0c) + g_rb[..., None] * at(y1c, x1c)
            + g_lb[..., None] * at(y0c, x1c) + g_rt[..., None] * at(y1c, x0c))


class DeformConv2d(nn.Module):
    """x [B, H, W, C] -> [B, H', W', features]."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1, stride: int = 1, modulation: bool = False,
                 use_bias: bool = False, dtype=torch.float32):
        super().__init__()
        k = kernel_size
        self.k, self.padding, self.stride = k, padding, stride
        self.modulation, self.dtype = modulation, dtype
        self.p_conv = Conv2d(in_channels, 2 * k * k, 3, stride, padding=1)
        nn.init.zeros_(self.p_conv.weight)
        if modulation:
            self.m_conv = Conv2d(in_channels, k * k, 3, stride, padding=1)
            nn.init.zeros_(self.m_conv.weight)
        self.conv = nn.Conv2d(in_channels, features, k, stride=k,
                              bias=use_bias)

    def forward(self, x):
        k, n, dt = self.k, self.k * self.k, self.dtype
        xc = x.permute(0, 3, 1, 2)
        off = self.p_conv.run(xc, dt).permute(0, 2, 3, 1).float()
        if self.modulation:
            mod = torch.sigmoid(self.m_conv.run(xc, dt)).permute(0, 2, 3, 1)
        if self.padding:
            p = self.padding
            x = F.pad(x, (0, 0, p, p, p, p))
        b, ho, wo = off.shape[:3]
        dev = x.device
        taps = torch.arange(n, device=dev)
        base_y = (torch.arange(ho, device=dev) * self.stride).float()
        base_x = (torch.arange(wo, device=dev) * self.stride).float()
        y = (base_y[:, None, None] + (taps // k).float())[None] + off[..., :n]
        xx = (base_x[None, :, None] + (taps % k).float())[None] + off[..., n:]
        sampled = bilinear_sample(x, y, xx)            # [B, ho, wo, n, C]
        if self.modulation:
            sampled = sampled * mod[..., None]
        sampled = sampled.reshape(b, ho, wo, -1).to(dt)
        # the stride-k conv over the taps as one product: [k, k, I, O]
        w = self.conv.weight.permute(2, 3, 1, 0).reshape(
            -1, self.conv.out_channels)
        out = sampled @ w.to(dt)
        if self.conv.bias is not None:
            out = out + self.conv.bias.to(dt)
        return out
