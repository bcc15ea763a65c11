"""EfficientNet feature extractor, eval path.

Counterpart of ``segtran_tpu/nn/backbones/efficientnet.py`` (reference
code/efficientnet/model.py, utils.py): round_filters / round_repeats
scaling, MBConv (expand -> depthwise -> SE from the input filters ->
project, swish, id-skip), BatchNorm eps 1e-3, endpoints after segments
0, 1, 2, 4 plus the head, and **static TF-SAME pads** computed from the
variant's nominal size chain (e.g. 380 for b4, halved after the stem
whatever the stem stride), not from the runtime size -- released weights
were trained with those pads.

Public tensors are NHWC as in the JAX package; convolutions run NCHW
logically (channels-last memory on the GPU). BatchNorm is folded in fp32
and applied in the compute dtype (``FoldedBatchNorm``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# name: (width_coefficient, depth_coefficient, nominal_resolution, dropout)
EFFICIENTNET_PARAMS = {
    "eff-tiny": (0.35, 0.1, 64, 0.2),
    "eff-b0": (1.0, 1.0, 224, 0.2),
    "eff-b1": (1.0, 1.1, 240, 0.2),
    "eff-b2": (1.1, 1.2, 260, 0.3),
    "eff-b3": (1.2, 1.4, 300, 0.3),
    "eff-b4": (1.4, 1.8, 380, 0.4),
    "eff-b5": (1.6, 2.2, 456, 0.4),
}

# B0 block args: (num_repeat, kernel, stride, expand_ratio, in_filters,
# out_filters, se_ratio) -- reference utils.py:512-520
_B0_BLOCKS = (
    (1, 3, 1, 1, 32, 16, 0.25),
    (2, 3, 2, 6, 16, 24, 0.25),
    (2, 5, 2, 6, 24, 40, 0.25),
    (3, 3, 2, 6, 40, 80, 0.25),
    (3, 5, 1, 6, 80, 112, 0.25),
    (4, 5, 2, 6, 112, 192, 0.25),
    (1, 3, 1, 6, 192, 320, 0.25),
)
_ENDPOINT_SEGMENTS = (0, 1, 2, 4)  # reference model.py:184


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """Reference utils.py:82-108."""
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    return int(math.ceil(depth_coefficient * repeats))


def _static_same_pad(size: Tuple[int, int], kernel: int, stride: int):
    """TF-SAME zero pad from a nominal size (utils.py:255-271):
    ((top, bottom), (left, right))."""
    ih, iw = size
    oh, ow = math.ceil(ih / stride), math.ceil(iw / stride)
    pad_h = max((oh - 1) * stride + kernel - ih, 0)
    pad_w = max((ow - 1) * stride + kernel - iw, 0)
    return ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))


def _ceil_div_size(size, stride):
    return (int(math.ceil(size[0] / stride)), int(math.ceil(size[1] / stride)))


@dataclass(frozen=True)
class _BlockSpec:
    kernel: int
    stride: int
    expand_ratio: int
    in_filters: int
    out_filters: int
    se_ratio: float
    pad: Tuple[Tuple[int, int], Tuple[int, int]]


def build_block_specs(variant: str, stem_stride: int = 2):
    """(blocks, endpoint_block_indices, stem_filters, head_filters,
    stem_pad) with the static pads of the nominal size chain."""
    w, d, res, _ = EFFICIENTNET_PARAMS[variant]
    size = (res, res)
    stem_filters = round_filters(32, w)
    stem_pad = _static_same_pad(size, 3, stem_stride)
    # the nominal size halves after the stem regardless of stem_stride
    size = _ceil_div_size(size, 2)
    blocks: List[_BlockSpec] = []
    endpoints = []
    for seg_i, (r, k, s, e, ci, co, se) in enumerate(_B0_BLOCKS):
        ci_r, co_r = round_filters(ci, w), round_filters(co, w)
        for j in range(round_repeats(r, d)):
            stride = s if j == 0 else 1
            blocks.append(_BlockSpec(k, stride, e, ci_r if j == 0 else co_r,
                                     co_r, se, _static_same_pad(size, k, stride)))
            if j == 0:
                size = _ceil_div_size(size, stride)
        if seg_i in _ENDPOINT_SEGMENTS:
            endpoints.append(len(blocks))
    head_filters = round_filters(1280, w)
    return tuple(blocks), tuple(endpoints), stem_filters, head_filters, stem_pad


def _pad_arg(pad):
    (t, b), (l, r) = pad
    return (l, r, t, b)


class _Conv(nn.Conv2d):
    """Conv2d in torch layout, applied with an explicit static pad in the
    compute dtype."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False, pad=None):
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=bias)
        self.static_pad = _pad_arg(pad) if pad is not None else None

    def run(self, x, dtype):
        if self.static_pad is not None and any(self.static_pad):
            x = F.pad(x, self.static_pad)
        b = self.bias.to(dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(dtype), b, self.stride, 0, 1,
                        self.groups)


class FoldedBatchNorm(nn.Module):
    """Eval BatchNorm folded into one per-channel affine,
    ``a = weight * rsqrt(var + eps)``, ``b = bias - mean * a`` in fp32,
    applied as ``x * a + b`` in the compute dtype (eps 1e-3, TF
    convention)."""

    def __init__(self, feats: int, eps: float = 1e-3):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(feats))
        self.bias = nn.Parameter(torch.zeros(feats))
        self.register_buffer("running_mean", torch.zeros(feats))
        self.register_buffer("running_var", torch.ones(feats))
        self.eps = eps

    def run(self, x, dtype):                      # x: [B, C, *spatial]
        a = self.weight.float() * torch.rsqrt(self.running_var.float() + self.eps)
        b = self.bias.float() - self.running_mean.float() * a
        shape = (-1,) + (1,) * (x.dim() - 2)
        return x * a.to(dtype).view(shape) + b.to(dtype).view(shape)


class MBConvBlock(nn.Module):
    def __init__(self, spec: _BlockSpec, dtype=torch.float32):
        super().__init__()
        s = self.spec = spec
        self.dtype = dtype
        expanded = s.in_filters * s.expand_ratio
        if s.expand_ratio != 1:
            self._expand_conv = _Conv(s.in_filters, expanded, 1)
            self._bn0 = FoldedBatchNorm(expanded)
        self._depthwise_conv = _Conv(expanded, expanded, s.kernel, s.stride,
                                     groups=expanded, pad=s.pad)
        self._bn1 = FoldedBatchNorm(expanded)
        self.has_se = bool(s.se_ratio) and 0 < s.se_ratio <= 1
        if self.has_se:
            # squeeze channels from the *input* filters (model.py:71)
            nsq = max(1, int(s.in_filters * s.se_ratio))
            self._se_reduce = _Conv(expanded, nsq, 1, bias=True)
            self._se_expand = _Conv(nsq, expanded, 1, bias=True)
        self._project_conv = _Conv(expanded, s.out_filters, 1)
        self._bn2 = FoldedBatchNorm(s.out_filters)

    def forward(self, x):                        # NCHW, compute dtype
        s, dt = self.spec, self.dtype
        inputs = x
        if s.expand_ratio != 1:
            x = F.silu(self._bn0.run(self._expand_conv.run(x, dt), dt))
        x = F.silu(self._bn1.run(self._depthwise_conv.run(x, dt), dt))
        if self.has_se:
            se = x.mean(dim=(2, 3), keepdim=True)
            se = F.silu(self._se_reduce.run(se, dt))
            x = torch.sigmoid(self._se_expand.run(se, dt)) * x
        x = self._bn2.run(self._project_conv.run(x, dt), dt)
        if s.stride == 1 and s.in_filters == s.out_filters:
            x = x + inputs
        return x


class EfficientNetFeatures(nn.Module):
    """The 5-level pyramid used by Segtran (reference model.py
    extract_endpoints)."""

    def __init__(self, variant: str = "eff-b4", stem_stride: int = 2,
                 in_channels: int = 3, dtype=torch.float32):
        super().__init__()
        blocks, self.ep_idx, stem_f, head_f, stem_pad = build_block_specs(
            variant, stem_stride)
        self.dtype = dtype
        self._conv_stem = _Conv(in_channels, stem_f, 3, stem_stride,
                                pad=stem_pad)
        self._bn0 = FoldedBatchNorm(stem_f)
        self._blocks = nn.ModuleList(MBConvBlock(b, dtype) for b in blocks)
        self._conv_head = _Conv(blocks[-1].out_filters, head_f, 1)
        self._bn1 = FoldedBatchNorm(head_f)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, H, W, C] -> 5 NHWC endpoints at strides
        (1, 2, 4, 8, 16) / stem_stride, in the compute dtype."""
        dt = self.dtype
        x = x.permute(0, 3, 1, 2).to(dt)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.silu(self._bn0.run(self._conv_stem.run(x, dt), dt))
        endpoints = []
        for i, blk in enumerate(self._blocks):
            x = blk(x)
            if (i + 1) in self.ep_idx:
                endpoints.append(x)
        x = F.silu(self._bn1.run(self._conv_head.run(x, dt), dt))
        endpoints.append(x)
        return tuple(e.permute(0, 2, 3, 1) for e in endpoints)
