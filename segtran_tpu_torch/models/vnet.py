"""V-Net 3-D baseline (``--net vnet`` of train3d / test3d, ``convert.cli
--model vnet``).

Counterpart of ``segtran_tpu/models/vnet.py`` (reference
code/networks/vnet.py): ConvBlock stacks (3x3x3 conv padded 1 + norm +
ReLU), stride-2 k=2 down convs and k=2 transposed up convs, additive
skips, a 1x1x1 ``out_conv`` giving fp32 logits. Normalisation
``batchnorm`` (flax semantics: momentum 0.9 keeps 0.9 of the old
statistic, eps 1e-5), ``groupnorm`` (16 groups, eps 1e-5), ``instancenorm``
(no affine) or ``none``. ``has_dropout``: whole-channel dropout (p 0.5)
after ``block_five`` and ``block_nine``, drawn from the ``generator`` that
``set_dropout_generator`` gives.

Volumes are [B, H, W, D, C] channels-last; the net runs channels-first
inside. Module names follow the reference's ``Sequential`` indices
(``block_one.conv.0.weight``, ``block_five_up.conv.0.weight``), so a
reference state_dict loads after layout changes alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.convbn import (BatchNorm, ChannelDropout, Conv3d, ConvTranspose3d,
                         GroupNorm, InstanceNorm, ncdhw, ndhwc)

NORMS = ("batchnorm", "groupnorm", "instancenorm", "none")
# the input's H, W and D must be multiples of this: both 3-D nets halve
# every axis four times
SPATIAL_MULTIPLE = 16


def check_spatial(shape, net: str) -> None:
    """ValueError naming ``shape`` [B, H, W, D, C] unless H, W and D are
    multiples of 16 (the skip adds / concats would not line up)."""
    if any(s % SPATIAL_MULTIPLE for s in shape[1:4]):
        raise ValueError(
            f"{net} halves H, W and D four times: its input "
            f"{tuple(shape)} needs every spatial size a multiple of "
            f"{SPATIAL_MULTIPLE}")


def make_norm(kind: str, feats: int) -> nn.Module:
    if kind == "batchnorm":
        return BatchNorm(feats, eps=1e-5, momentum=0.9)
    if kind == "groupnorm":
        return GroupNorm(16, feats, eps=1e-5)
    if kind == "instancenorm":
        return InstanceNorm(1e-5)
    raise ValueError(f"normalization {kind!r} not in {NORMS}")


def apply_norm(norm: nn.Module, x: torch.Tensor, dtype) -> torch.Tensor:
    if isinstance(norm, BatchNorm):
        return norm(x, dtype)
    return norm.run(x, dtype)


class _Stage(nn.Module):
    """A reference ``Sequential`` of (conv, [norm], ReLU) groups, held as
    ``conv`` with the reference's indices."""

    def __init__(self, convs, normalization: str):
        super().__init__()
        layers = []
        for conv in convs:
            layers.append(conv)
            if normalization != "none":
                layers.append(make_norm(normalization, conv.out_channels))
            layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)
        self.per = 3 if normalization != "none" else 2

    def forward(self, x, dtype):
        for i in range(0, len(self.conv), self.per):
            x = self.conv[i].run(x, dtype)
            if self.per == 3:
                x = apply_norm(self.conv[i + 1], x, dtype)
            x = F.relu(x)
        return x


class ConvBlock(_Stage):
    def __init__(self, n_stages: int, n_in: int, n_filters: int,
                 normalization: str = "none"):
        super().__init__([Conv3d(n_in if i == 0 else n_filters, n_filters,
                                 3, padding=1) for i in range(n_stages)],
                         normalization)


class DownBlock(_Stage):
    """k = s = 2 conv, no padding."""

    def __init__(self, n_in: int, n_filters: int,
                 normalization: str = "none", stride: int = 2):
        super().__init__([Conv3d(n_in, n_filters, stride, stride)],
                         normalization)


class UpBlock(_Stage):
    """k = s = 2 transposed conv."""

    def __init__(self, n_in: int, n_filters: int,
                 normalization: str = "none", stride: int = 2):
        super().__init__([ConvTranspose3d(n_in, n_filters, stride, stride)],
                         normalization)


class VNet(nn.Module):
    def __init__(self, n_channels: int = 3, num_classes: int = 2,
                 n_filters: int = 16, normalization: str = "none",
                 has_dropout: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        nf, nm = n_filters, normalization
        self.block_one = ConvBlock(1, n_channels, nf, nm)
        self.block_one_dw = DownBlock(nf, 2 * nf, nm)
        self.block_two = ConvBlock(2, 2 * nf, 2 * nf, nm)
        self.block_two_dw = DownBlock(2 * nf, 4 * nf, nm)
        self.block_three = ConvBlock(3, 4 * nf, 4 * nf, nm)
        self.block_three_dw = DownBlock(4 * nf, 8 * nf, nm)
        self.block_four = ConvBlock(3, 8 * nf, 8 * nf, nm)
        self.block_four_dw = DownBlock(8 * nf, 16 * nf, nm)
        self.block_five = ConvBlock(3, 16 * nf, 16 * nf, nm)
        self.block_five_up = UpBlock(16 * nf, 8 * nf, nm)
        self.block_six = ConvBlock(3, 8 * nf, 8 * nf, nm)
        self.block_six_up = UpBlock(8 * nf, 4 * nf, nm)
        self.block_seven = ConvBlock(3, 4 * nf, 4 * nf, nm)
        self.block_seven_up = UpBlock(4 * nf, 2 * nf, nm)
        self.block_eight = ConvBlock(2, 2 * nf, 2 * nf, nm)
        self.block_eight_up = UpBlock(2 * nf, nf, nm)
        self.block_nine = ConvBlock(1, nf, nf, nm)
        self.out_conv = Conv3d(nf, num_classes, 1)
        self.dropout = ChannelDropout(0.5) if has_dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, D, C] -> fp32 logits [B, H, W, D, num_classes]."""
        check_spatial(x.shape, "VNet")
        dt = self.dtype
        x1 = self.block_one(ncdhw(x, dt), dt)
        x2 = self.block_two(self.block_one_dw(x1, dt), dt)
        x3 = self.block_three(self.block_two_dw(x2, dt), dt)
        x4 = self.block_four(self.block_three_dw(x3, dt), dt)
        x5 = self.block_five(self.block_four_dw(x4, dt), dt)
        if self.dropout is not None:
            x5 = self.dropout(x5)
        x6 = self.block_six(self.block_five_up(x5, dt) + x4, dt)
        x7 = self.block_seven(self.block_six_up(x6, dt) + x3, dt)
        x8 = self.block_eight(self.block_seven_up(x7, dt) + x2, dt)
        x9 = self.block_nine(self.block_eight_up(x8, dt) + x1, dt)
        if self.dropout is not None:
            x9 = self.dropout(x9)
        return ndhwc(self.out_conv.run(x9, dt).float())
