"""Factored (reassociated) segmentation head for the output-FPN tail.

Counterpart of ``segtran_tpu/nn/heads.py``. With dropout off, every op of
the tail is linear, so
``out_conv(bridge(curr) + upsample(vfeat))`` is computed as
``(bridge . out_conv)(curr) + upsample(out_conv_nobias(vfeat))``: the
full-resolution ops run at num_classes channels.
"""
from __future__ import annotations

import torch
from torch import nn


class Conv1x1Params(nn.Conv2d):
    """A 1x1 conv's parameters in torch layout (weight [out, in, 1, 1],
    bias [out]) without applying it; ``matrix()`` gives ([in, out], bias)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__(in_features, features, 1, bias=use_bias)

    def matrix(self):
        return self.weight[:, :, 0, 0].t(), self.bias


def compose_1x1(w_first, b_first, w_second, b_second):
    """Weights of ``second(first(x))``: x @ (W1 W2) + (b1 W2 + b2)."""
    w = w_first @ w_second
    if b_first is None:
        return w, b_second
    b = b_first @ w_second
    return w, (b if b_second is None else b + b_second)


def apply_pointwise(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x [..., Cin] @ w [Cin, Cout] (+ b), in x.dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    return y + b.to(x.dtype) if b is not None else y
