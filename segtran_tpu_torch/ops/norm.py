"""LayerNorm with the JAX package's two numeric branches, train-mode
BatchNorm with flax semantics, the freeze of running statistics that a
checkpoint's recompute runs under, and the reductions over a data-parallel
step's global batch.

* fp32: flax ``nn.LayerNorm`` math -- fp32 statistics with the fast variance
  ``E[x^2] - mean^2`` clamped at 0, then ``(x - mean) * (rsqrt(var + eps) *
  scale) + bias``.
* bf16/fp16: ``FastLayerNorm`` -- the same fp32 statistics, but the
  elementwise normalize/scale/shift runs in the half dtype, so every
  full-size tensor stays half width.

Parameters are named ``weight``/``bias`` (torch LayerNorm names).

The global batch: JAX's data-parallel step (``parallel/mesh.py``) is one
program written on the global batch, so every reduction over the batch
axis spans the devices. Here each rank of a ``torch.distributed`` group
runs its rows of the batch; within ``global_batch(group)`` the reductions
that are not a mean of per-example values (train-mode BatchNorm
statistics, the batch-joint loss terms) go through ``global_sum`` /
``global_mean``, all-reduces whose backward all-reduces the incoming
gradients, and the step averages its gradients over the group
(``average_gradients``). Rows are split evenly, so the mean of the ranks'
means is the global mean. Without a group, or with one rank, every helper
is the identity.

Every all-reduce of these helpers is counted (``utils/tracing.py``
counters ``dp.allreduce_calls`` and ``dp.allreduce_bytes``: a statistics
all-reduce in the forward, its gradient's in the backward, each gradient
all-reduce), and ``average_gradients`` records its all-reduces as the span
``dp.grad_allreduce``: the host's enqueue of them (NCCL runs them on the
device after it returns).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..utils import tracing

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


_BATCH_GROUPS: list = []


@contextlib.contextmanager
def global_batch(group, microbatches: int = 1):
    """Within this context the batch reductions of the helpers below span
    the ranks of ``group`` (a ``torch.distributed`` process group over the
    data axis). A group of one rank, or None, changes nothing.
    ``microbatches``: the step's gradient-accumulation count, which sets
    the rows a rank holds (``shard_rows``). Not thread-local: the autograd
    engine's device threads see it too."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    _BATCH_GROUPS.append((group, microbatches))
    try:
        yield
    finally:
        _BATCH_GROUPS.pop()


def batch_group():
    """The data group of the innermost ``global_batch``, or None."""
    return _BATCH_GROUPS[-1][0] if _BATCH_GROUPS else None


def batch_shard():
    """(this rank's index, number of ranks) along the data axis; (0, 1)
    outside a group."""
    g = batch_group()
    return (0, 1) if g is None else (dist.get_rank(g),
                                      dist.get_world_size(g))


def shard_rows(n: int, index: int, count: int, microbatches: int = 1):
    """The rows of a global batch of ``n`` that rank ``index`` of ``count``
    holds, in its order: of each of the ``microbatches`` consecutive
    microbatches its contiguous 1/count (JAX shards each microbatch over
    the data axis), so its own k-th microbatch is its part of the global
    k-th."""
    if n % (count * microbatches):
        raise ValueError(f"global batch {n} must be divisible by the "
                         f"data-parallel device count {count} times "
                         f"{microbatches} microbatch(es)")
    per = n // (count * microbatches)
    return [j * count * per + index * per + r
            for j in range(microbatches) for r in range(per)]


def local_rows(n: int):
    """This rank's rows of the global batch whose local part has ``n``
    rows (``shard_rows`` under the innermost ``global_batch``)."""
    index, count = batch_shard()
    micro = _BATCH_GROUPS[-1][1] if _BATCH_GROUPS else 1
    return shard_rows(n * count, index, count, micro)


def global_rows(draw, batch: int, *args, **kwargs):
    """``draw(global batch, *args, **kwargs)``'s rows of this rank: the
    draws of the whole global batch of a data-parallel step (every rank's
    generator is seeded alike and draws alike), the rows the rank holds
    (``local_rows``) kept of each per-sample field, so that a rank's
    samples get the random numbers one process gives them (augmentation,
    drop-connect). Outside a group it is ``draw(batch, ...)``."""
    _, count = batch_shard()
    out = draw(batch * count, *args, **kwargs)
    if count == 1:
        return out
    rows = local_rows(batch)

    def take(v):
        if isinstance(v, dict):
            return {k: take(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(take(x) for x in v)
        return v[rows]
    return take(out)


def _all_reduce(x: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (sum) in place, counted."""
    tracing.count("dp.allreduce_calls")
    tracing.count("dp.allreduce_bytes", x.numel() * x.element_size())
    dist.all_reduce(x, group=group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks; the gradient of each rank's input is the
    sum of the ranks' gradients of the output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group``, differentiable: each
    rank's input gradient is the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(x, group)


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks of the data group (differentiable)."""
    g = batch_group()
    return x if g is None else all_reduce_sum(x, g)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks of the data group (differentiable)."""
    g = batch_group()
    return x if g is None else all_reduce_sum(x, g) / dist.get_world_size(g)


def batch_moments(xs: torch.Tensor, dims) -> tuple:
    """(E[x], E[x^2]) over ``dims`` of the global batch (one all-reduce)."""
    m = torch.stack([xs.mean(dims), xs.square().mean(dims)])
    m = global_mean(m)
    return m[0], m[1]


@torch.no_grad()
def average_gradients(params) -> None:
    """Average the .grad of ``params`` over the data group in place (one
    all-reduce per dtype); a parameter without a gradient has none on
    every rank, the same graph having run on each."""
    g = batch_group()
    if g is None:
        return
    n = dist.get_world_size(g)
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    with tracing.span("dp.grad_allreduce"):
        for grads in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in grads])
            _all_reduce(flat, g)
            flat.div_(n)
            off = 0
            for t in grads:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


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
    unbiased variance and the inverse momentum. Within ``global_batch``
    the statistics are the global batch's."""
    dims = [0] + list(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    xs = x if x.dtype == torch.float64 else x.float()
    mean, mean_sq = batch_moments(xs, dims)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
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
