"""EfficientNet feature extractor.

Counterpart of ``segtran_tpu/nn/backbones/efficientnet.py`` (reference
code/efficientnet/model.py, utils.py): round_filters / round_repeats
scaling, MBConv (expand -> depthwise -> SE from the input filters ->
project, swish, id-skip + drop-connect), BatchNorm eps 1e-3 / momentum
0.99, endpoints after segments 0, 1, 2, 4 plus the head, and **static
TF-SAME pads** computed from the variant's nominal size chain (e.g. 380 for
b4, halved after the stem whatever the stem stride), not from the runtime
size -- released weights were trained with those pads.

Public tensors are NHWC as in the JAX package; convolutions run NCHW
logically (channels-last memory on the GPU). BatchNorm is folded in fp32
and applied in the compute dtype (``FoldedBatchNorm``), on the running
statistics in eval and on the batch statistics in training
(``module.train()``). In training, residual blocks drop their branch per
sample (drop-connect, rate ``drop_connect_rate * i / n`` for block i) and
``remat_blocks`` recomputes each block in the backward (``nn.remat``).

``fused_eval`` sends the eval forward of the blocks that JAX's gate admits
(stride 1, an expand, 36 <= H <= 144) through the fused front-half kernel
(``kernels/mbconv.py``); it changes neither the parameters nor training.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...kernels.mbconv import fold_bn, mbconv_front
from ...ops.norm import update_running_stats
from ..remat import remat

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
    """BatchNorm folded into one per-channel affine,
    ``a = weight * rsqrt(var + eps)``, ``b = bias - mean * a`` in fp32
    (fp64 for an fp64 ``x``), applied as ``x * a + b`` in the compute
    dtype (eps 1e-3, momentum 0.99, TF convention). In training, mean and
    var are the batch's, in that type: ``E[x]`` and the biased ``E[x^2] -
    E[x]^2`` with no clamp, as JAX's ``FoldedBatchNorm`` takes them; the
    running statistics move toward them."""

    def __init__(self, feats: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(feats))
        self.bias = nn.Parameter(torch.zeros(feats))
        self.register_buffer("running_mean", torch.zeros(feats))
        self.register_buffer("running_var", torch.ones(feats))
        self.eps = eps
        self.momentum = momentum

    def folded(self, mean=None, var=None, ct=torch.float32):
        """(a, b) in ``ct``, from the running statistics unless given."""
        return fold_bn(self.weight.to(ct), self.bias.to(ct),
                       self.running_mean.to(ct) if mean is None else mean,
                       self.running_var.to(ct) if var is None else var,
                       self.eps)

    def run(self, x, dtype):                      # x: [B, C, *spatial]
        ct = torch.promote_types(x.dtype, torch.float32)
        if self.training:
            dims = [0] + list(range(2, x.dim()))
            xf = x.to(ct)
            mean = xf.mean(dims)
            var = xf.square().mean(dims) - mean.square()
            update_running_stats(self, mean, var, self.momentum)
            a, b = self.folded(mean, var, ct)
        else:
            a, b = self.folded(ct=ct)
        shape = (-1,) + (1,) * (x.dim() - 2)
        return x * a.to(dtype).view(shape) + b.to(dtype).view(shape)


def _drop_connect(x, rate: float, generator=None):
    """Per-sample stochastic depth (reference utils.py:129-154): keep each
    sample's branch with probability 1 - rate, scaled by 1 / (1 - rate)
    (the scale rounded to x.dtype, as in JAX)."""
    keep = 1.0 - rate
    u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=generator,
                   device=x.device)
    mask = (u < keep).to(x.dtype)
    return x / torch.tensor(keep, dtype=x.dtype, device=x.device) * mask


class MBConvBlock(nn.Module):
    def __init__(self, spec: _BlockSpec, drop_rate: float = 0.0,
                 fused_eval: bool = False, dtype=torch.float32):
        super().__init__()
        s = self.spec = spec
        self.drop_rate = drop_rate
        self.fused_eval = fused_eval
        self.dtype = dtype
        self.generator = None            # drop-connect's, if set
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
        # the fused eval's kernel operands: (sources, their state, operands)
        self._front_cache = None

    def forward(self, x):                        # NCHW, compute dtype
        s, dt = self.spec, self.dtype
        if (self.fused_eval and not self.training and s.stride == 1
                and s.expand_ratio != 1 and 36 <= x.shape[2] <= 144):
            # JAX's gate (measured on the TPU), kept so that both packages
            # take the same path
            return self._fused_eval(x)
        inputs = x
        if s.expand_ratio != 1:
            x = F.silu(self._bn0.run(self._expand_conv.run(x, dt), dt))
        x = F.silu(self._bn1.run(self._depthwise_conv.run(x, dt), dt))
        if self.has_se:
            x = self._se(x, x.mean(dim=(2, 3), keepdim=True))
        x = self._bn2.run(self._project_conv.run(x, dt), dt)
        if s.stride == 1 and s.in_filters == s.out_filters:
            if self.training and self.drop_rate > 0:
                x = _drop_connect(x, self.drop_rate, self.generator)
            x = x + inputs
        return x

    def _se(self, x, mean):
        dt = self.dtype
        se = F.silu(self._se_reduce.run(mean, dt))
        return torch.sigmoid(self._se_expand.run(se, dt)) * x

    def _front_operands(self):
        """``mbconv_front``'s operands in the kernel's types, contiguous:
        w_exp [Cin, Cexp] in the compute dtype, the folded BatchNorms in
        fp32, w_dw [k, k, Cexp] fp32 holding compute-dtype values (as the
        unfused path rounds it). Built once and kept while every source
        tensor is the same object with the same version, dtype and device,
        so load_state_dict, an in-place edit, .to() and .cuda() rebuild it
        (the cache holds the sources, so a replaced one cannot pass for
        them); not kept while a source is an inference tensor (it has no
        version)."""
        s, dt = self.spec, self.dtype
        src = [self._expand_conv.weight, self._depthwise_conv.weight]
        for bn in (self._bn0, self._bn1):
            src += [bn.weight, bn.bias, bn.running_mean, bn.running_var]
        keep = not any(t.is_inference() for t in src)
        state = ([(t._version, t.dtype, t.device) for t in src] if keep
                 else None)
        cache = self._front_cache
        if keep and cache is not None and cache[1] == state \
                and all(a is t for a, t in zip(cache[0], src)):
            return cache[2]
        expanded = s.in_filters * s.expand_ratio
        with torch.inference_mode(False), torch.no_grad():
            w_exp = self._expand_conv.weight.reshape(expanded, s.in_filters)
            w_dw = self._depthwise_conv.weight.reshape(
                expanded, s.kernel, s.kernel).permute(1, 2, 0)
            ops = (w_exp.t().to(dt).contiguous(), *self._bn0.folded(),
                   w_dw.to(dt).float().contiguous(), *self._bn1.folded())
        if keep:
            self._front_cache = (src, state, ops)
        return ops

    def _fused_eval(self, x):
        """The eval forward through ``mbconv_front`` (JAX
        ``_fused_eval_call``): the kernel reads the channels-last input
        through an NHWC view and gives the depthwise output and the SE
        mean; SE scaling, project, BN2 and the residual stay in PyTorch."""
        s, dt = self.spec, self.dtype
        dw, se_mean = mbconv_front(
            x.permute(0, 2, 3, 1), *self._front_operands(),
            kernel=s.kernel, stride=s.stride, pad=s.pad)
        dw = dw.permute(0, 3, 1, 2)
        if self.has_se:
            dw = self._se(dw, se_mean.to(dt)[:, :, None, None])
        y = self._bn2.run(self._project_conv.run(dw, dt), dt)
        if s.in_filters == s.out_filters:
            y = y + x
        return y


class EfficientNetFeatures(nn.Module):
    """The 5-level pyramid used by Segtran (reference model.py
    extract_endpoints)."""

    def __init__(self, variant: str = "eff-b4", stem_stride: int = 2,
                 in_channels: int = 3, drop_connect_rate: float = 0.2,
                 fused_eval: bool = False, remat_blocks: bool = False,
                 dtype=torch.float32):
        super().__init__()
        blocks, self.ep_idx, stem_f, head_f, stem_pad = build_block_specs(
            variant, stem_stride)
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        self._conv_stem = _Conv(in_channels, stem_f, 3, stem_stride,
                                pad=stem_pad)
        self._bn0 = FoldedBatchNorm(stem_f)
        n = len(blocks)
        self._blocks = nn.ModuleList(
            MBConvBlock(b, drop_connect_rate * i / n, fused_eval, dtype)
            for i, b in enumerate(blocks))
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
        rematted = (self.remat_blocks and self.training
                    and torch.is_grad_enabled())
        endpoints = []
        for i, blk in enumerate(self._blocks):
            x = remat(blk, x) if rematted else blk(x)
            if (i + 1) in self.ep_idx:
                endpoints.append(x)
        x = F.silu(self._bn1.run(self._conv_head.run(x, dt), dt))
        endpoints.append(x)
        return tuple(e.permute(0, 2, 3, 1) for e in endpoints)
