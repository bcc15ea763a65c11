"""Inception-v1 I3D feature pyramid.

Counterpart of ``segtran_tpu/nn/backbones/i3d.py`` (reference
code/networks/aj_i3d/aj_i3d.py): Unit3D = Conv3d + BatchNorm (eps 1e-3) +
ReLU with TF-SAME padding computed from the runtime size (the odd pad
element at the end: the 7x7x7 stride-2 stem pads (2, 3) on even sizes),
SAME max pools padded with -inf, the Inception modules, and the five taps
Segtran3d uses (MaxPool3d_2a_3x3, Conv3d_2c_3x3, Mixed_3c, Mixed_4f,
Mixed_5c). ``do_pool1=False`` (bb_feat_upsize) drops the 2a max pool.
In eval BatchNorm is folded into an affine in the compute dtype; in
training (``model.train()``) it normalises with batch statistics and
updates its running statistics with flax semantics (momentum 0.99,
``ops/norm.batch_norm_train``).

Module names follow the JAX package ('Conv3d_1a_7x7' -> conv3d, bn;
'Mixed_3b' -> b0, b1a, b1b, b2a, b2b, b3b), so converted weights load by
name. Public tensors are channels-last [B, T, H, W, C]; the convolutions
run channels-first logically and channels-last-3d in memory on the GPU.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.norm import batch_norm_train
from ...ops.resize import max_pool_same, pad_arg, same_pads
from .efficientnet import FoldedBatchNorm


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 dtype=torch.float32):
        super().__init__()
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=False)
        self.bn = FoldedBatchNorm(cout)
        self.dtype = dtype

    def forward(self, x):                        # [B, C, T, H, W]
        c = self.conv3d
        pads = same_pads(x.shape[2:], c.kernel_size, c.stride)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            x, padding = F.pad(x, pad_arg(pads)), 0
        x = F.conv3d(x, c.weight.to(self.dtype), None, c.stride, padding)
        if self.training:
            return F.relu(batch_norm_train(x, self.bn, 0.99, self.dtype))
        return F.relu(self.bn.run(x, self.dtype))


class InceptionModule(nn.Module):
    def __init__(self, cin: int, oc: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.b0 = Unit3D(cin, oc[0], dtype=dtype)
        self.b1a = Unit3D(cin, oc[1], dtype=dtype)
        self.b1b = Unit3D(oc[1], oc[2], (3, 3, 3), dtype=dtype)
        self.b2a = Unit3D(cin, oc[3], dtype=dtype)
        self.b2b = Unit3D(oc[3], oc[4], (3, 3, 3), dtype=dtype)
        self.b3b = Unit3D(cin, oc[5], dtype=dtype)

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


# (name, output channels (b0, b1a, b1b, b2a, b2b, b3b)); a max pool
# (kernel, stride) precedes the entries that name one
_MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32), ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64), None),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64), ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64), None),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64), None),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64), None),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128), None),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128), ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128), None),
)
_TAPS = ("Mixed_3c", "Mixed_4f", "Mixed_5c")


class I3DFeatures(nn.Module):
    """[B, T, H, W, 3] -> the 5 taps (dims 64, 192, 480, 832, 1024),
    channels-last, in the compute dtype."""

    def __init__(self, do_pool1: bool = True, dtype=torch.float32):
        super().__init__()
        self.do_pool1, self.dtype = do_pool1, dtype
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), dtype)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, dtype=dtype)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), dtype=dtype)
        cin = 192
        self._pools = {}
        for name, oc, pool in _MIXED:
            setattr(self, name, InceptionModule(cin, oc, dtype))
            self._pools[name] = pool
            cin = oc[0] + oc[2] + oc[4] + oc[5]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = x.permute(0, 4, 1, 2, 3).to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        x = self.Conv3d_1a_7x7(x)
        if self.do_pool1:
            x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        taps = [x]
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        taps.append(x)
        for name, _, _ in _MIXED:
            pool = self._pools[name]
            if pool is not None:
                x = max_pool_same(x, *pool)
            x = getattr(self, name)(x)
            if name in _TAPS:
                taps.append(x)
        return tuple(t.permute(0, 2, 3, 4, 1) for t in taps)
