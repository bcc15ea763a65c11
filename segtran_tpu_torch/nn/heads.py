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


class Conv1x1Params(nn.Module):
    """A 1x1 (or 1x1x1) conv's parameters in torch layout (weight [out, in,
    1, ...], bias [out]) without applying it; ``matrix()`` gives
    ([in, out], bias)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 spatial_ndim: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(
            (features, in_features) + (1,) * spatial_ndim) / in_features ** 0.5)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def matrix(self):
        return self.weight.reshape(self.weight.shape[:2]).t(), self.bias


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


def compose_fold_head(w_u, b_u, w_o, b_o, k: int):
    """Compose the 'conv' depth-unpool channel fold (C -> F*K, output
    channel f*K + kk) with the head W_o [F, ncls]:
    W[c, kk*ncls + n] = sum_f w_u[c, f*K + kk] w_o[f, n]. Returns
    (W [C, K*ncls], b [K*ncls]); the caller moves the K*ncls channels into
    the depth axis (block order kk*D + d)."""
    c = w_u.shape[0]
    f = w_u.shape[1] // k
    w = torch.einsum("cfk,fn->ckn", w_u.reshape(c, f, k), w_o)
    b = torch.einsum("fk,fn->kn", b_u.reshape(f, k), w_o)
    if b_o is not None:
        b = b + b_o[None, :]
    return w.reshape(c, k * w_o.shape[1]), b.reshape(-1)
