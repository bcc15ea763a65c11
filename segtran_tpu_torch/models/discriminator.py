"""Domain discriminator for adversarial DA, also the learned vCDR
estimator (counterpart of ``segtran_tpu/models/discriminator.py``;
reference code/networks/discriminator.py:24-86): 5 stride-2 4x4 convs
without bias, each but the last followed by BatchNorm (momentum 0.9, eps
1e-5, flax semantics) and LeakyReLU(0.2), an optional gradient-reversal
first layer, and an average-pool head or, without ``do_avgpool``, a
flatten + Linear ``tail.1``. The output is fp32.

Module names follow the reference's torch Sequential indices, which shift
by one when the gradient reversal is inserted (``model.1`` is the first
conv with it, ``model.0`` without), so the JAX package's
``model_{idx}`` scopes convert by the generic rule.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..adapt.revgrad import gradient_reversal
from ..ops.norm import BatchNorm


def _conv_out(n: int) -> int:
    return (n + 2 - 4) // 2 + 1


class Discriminator(nn.Module):
    """x [B, H, W, in_channels] -> [B, num_classes] logits (fp32).
    ``in_hw`` (H, W) sizes the ``tail`` head; only ``do_avgpool=False``
    needs it."""

    def __init__(self, in_channels: int, num_classes: int = 2,
                 do_avgpool: bool = True, do_revgrad: bool = True,
                 num_base_chan: int = 32, revgrad_alpha: float = 1.0,
                 in_hw: Optional[Sequence[int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.do_avgpool, self.do_revgrad = do_avgpool, do_revgrad
        self.revgrad_alpha, self.dtype = revgrad_alpha, dtype
        nb = num_base_chan
        chans = [in_channels, nb, 2 * nb, 4 * nb, 8 * nb]
        idx = 1 if do_revgrad else 0
        layers = {}
        for cin, cout in zip(chans[:-1], chans[1:]):
            layers[str(idx)] = nn.Conv2d(cin, cout, 4, 2, 1, bias=False)
            layers[str(idx + 1)] = BatchNorm(cout)
            idx += 3
        layers[str(idx)] = nn.Conv2d(chans[-1], num_classes, 4, 2, 1,
                                     bias=False)
        self.model = nn.ModuleDict(layers)
        first = 1 if do_revgrad else 0
        self.convs = [str(i) for i in range(first, idx + 1, 3)]
        if not do_avgpool:
            if in_hw is None:
                raise ValueError("the tail head (do_avgpool=False) needs "
                                 "in_hw")
            h, w = in_hw
            for _ in range(5):
                h, w = _conv_out(h), _conv_out(w)
            self.tail = nn.ModuleDict(
                {"1": nn.Linear(num_classes * h * w, num_classes)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if min(x.shape[1], x.shape[2]) < 32:
            # 5 stride-2 convs collapse anything smaller to nothing
            raise ValueError(
                f"Discriminator input spatial dims {tuple(x.shape[1:3])} too "
                "small: the 5 stride-2 convs need >= 32x32 (use --adv mask, "
                "or a larger patch size, for small feature grids)")
        dt = self.dtype
        if self.do_revgrad:
            x = gradient_reversal(x, self.revgrad_alpha)
        x = x.permute(0, 3, 1, 2).to(dt)
        for i, key in enumerate(self.convs):
            conv = self.model[key]
            x = F.conv2d(x, conv.weight.to(dt), None, 2, 1)
            if i < len(self.convs) - 1:
                bn = self.model[str(int(key) + 1)]
                x = F.leaky_relu(bn(x, dt), 0.2)
        if self.do_avgpool:
            x = x.mean((2, 3))
        else:
            tail = self.tail["1"]
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            x = F.linear(x, tail.weight.to(dt), tail.bias.to(dt))
        return x.float()
