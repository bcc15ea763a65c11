"""LayerNorm with the JAX package's two numeric branches, train-mode
BatchNorm with flax semantics, and the freeze of running statistics that a
checkpoint's recompute runs under.

* fp32: flax ``nn.LayerNorm`` math -- fp32 statistics with the fast variance
  ``E[x^2] - mean^2`` clamped at 0, then ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``.
* bf16/fp16: ``FastLayerNorm`` -- the same fp32 statistics, but the
  elementwise normalize/scale/shift runs in the half dtype, so every
  full-size tensor stays half width.

Parameters are named ``weight``/``bias`` (torch LayerNorm names).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

_HALF = (torch.bfloat16, torch.float16)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """Normalize over the last axis; returns ``dtype``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp(x32.square().mean(-1, keepdim=True) - mean.square(),
                      min=0.0)
    inv = torch.rsqrt(var + eps)
    if dtype in _HALF:
        dt = x.dtype if x.dtype in _HALF else torch.float32
        y = (x.to(dt) - mean.to(dt)) * inv.to(dt)
        if weight is not None:
            y = y * weight.to(dt)
        if bias is not None:
            y = y + bias.to(dt)
        return y.to(dtype)
    mul = inv if weight is None else inv * weight.float()
    y = (x32 - mean) * mul
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


class LayerNorm(nn.Module):
    """Module form of :func:`layer_norm` (flax ``layer_norm(dtype, ...)``)."""

    def __init__(self, num_feat: int, eps: float, affine: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(num_feat))
            self.bias = nn.Parameter(torch.zeros(num_feat))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype)


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within this context no BatchNorm inside ``module`` moves its running
    statistics: a checkpoint's recompute of the module's forward runs under
    it, so that a forward run twice updates them once, as JAX's
    ``nn.remat`` does. Nests: each module gets its own flag back."""
    mods = list(module.modules())
    before = [m.__dict__.get("stats_frozen", False) for m in mods]
    for m in mods:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m, flag in zip(mods, before):
            m.stats_frozen = flag


@torch.no_grad()
def update_running_stats(bn: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor, momentum: float) -> None:
    """``running = momentum * running + (1 - momentum) * batch`` on the
    ``running_mean``/``running_var`` buffers of ``bn``, unless frozen."""
    if getattr(bn, "stats_frozen", False):
        return
    bn.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
    bn.running_var.mul_(momentum).add_((1.0 - momentum) * var)


def batch_norm_train(x: torch.Tensor, bn: nn.Module, momentum: float,
                     dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.BatchNorm(use_running_average=False)`` on x [B, C, *spatial]
    (flax 0.12 ``_compute_stats``/``_normalize``): batch mean and the fast
    variance ``E[x^2] - E[x]^2`` clipped at 0, both in fp32 (fp64 for an
    fp64 ``x``) over every axis but C; ``(x - mean) * (rsqrt(var + eps) *
    weight) + bias`` in that type, returned in ``dtype``. The running
    statistics of ``bn`` (buffers ``running_mean``/``running_var``) move
    to ``momentum * running + (1 - momentum) * batch`` with the biased
    batch variance -- not ``nn.BatchNorm3d``'s update, which takes the
    unbiased variance and the inverse momentum."""
    dims = [0] + list(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    xs = x if x.dtype == torch.float64 else x.float()
    mean = xs.mean(dims)
    var = torch.clamp(xs.square().mean(dims) - mean.square(), min=0.0)
    update_running_stats(bn, mean, var, momentum)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(xs.dtype)
    y = (xs - mean.view(shape)) * mul.view(shape) \
        + bn.bias.to(xs.dtype).view(shape)
    return y.to(dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon, dtype)`` over dim 1 of a
    channels-first [B, C, *spatial] tensor: in training the batch's
    statistics (``batch_norm_train``, which moves the running ones), in
    eval, or always with ``use_running_average``, the running ones, with
    the normalize in fp32 (fp64 for an fp64 ``x``) and the result in
    ``dtype``. Parameter and buffer
    names are torch's (``weight``, ``bias``, ``running_mean``,
    ``running_var``)."""

    def __init__(self, feats: int, eps: float = 1e-5, momentum: float = 0.9,
                 use_running_average: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(feats))
        self.bias = nn.Parameter(torch.zeros(feats))
        self.register_buffer("running_mean", torch.zeros(feats))
        self.register_buffer("running_var", torch.ones(feats))
        self.eps, self.momentum = eps, momentum
        self.use_running_average = use_running_average

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.training and not self.use_running_average:
            return batch_norm_train(x, self, self.momentum, dtype)
        shape = (-1,) + (1,) * (x.dim() - 2)
        ct = torch.promote_types(x.dtype, torch.float32)
        mul = torch.rsqrt(self.running_var.to(ct) + self.eps) \
            * self.weight.to(ct)
        return ((x.to(ct) - self.running_mean.to(ct).view(shape))
                * mul.view(shape) + self.bias.to(ct).view(shape)).to(dtype)
