"""The plain reference of the BraTS recipe step data-parallel over the
ranks of a ``torch.distributed`` group: each rank holds its shard of the
global batch (four shards of 4 for the global 16 over four cards) and
runs ``nets.segtran3d`` in training mode on it, with every BatchNorm on
the global batch's statistics (the ranks' sums of E[x] and E[x^2],
all-reduced, the backward all-reducing the gradients of the
statistics), the loss and the gradients averaged
over the ranks before the global clip, then BertAdam on every rank alike
(``steps.Trainer``). Float32; nothing of the program is imported.

Why over the ranks and not shard by shard on one card: the float32 step
on a shard of 4 already takes most of one card's memory (the program's
bf16 step on 4 peaks at 20 GB), and a second pass over the four shards
would hold the graphs of all four for one backward. On four cards each
holds one shard's graph, as the program does. The loss's mean over a
shard is a mean of per-sample terms, so with equal shards the ranks'
mean is the global batch's.

Departure: the score clamp (at ``attn_clip`` when the largest score
exceeds it) takes the largest score of the rank's shard, as the program's
step does; with the configuration's clip of 500 neither side reaches it.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from . import nets, steps


class _Sum(torch.autograd.Function):
    """The ranks' sum; each rank's input gradient is the ranks' sum of the
    output's gradients."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def global_batch_norm(x, sd, key, eps=1e-3):
    """Training BatchNorm on the statistics of the whole group's batch:
    E[x] and E[x^2] of each shard averaged over the ranks, the biased
    variance E[x^2] - E[x]^2."""
    dims = [0] + list(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    moments = torch.stack([x.mean(dims), x.square().mean(dims)])
    moments = _Sum.apply(moments) / dist.get_world_size()
    mean, var = moments[0], moments[1] - moments[0].square()
    inv = torch.rsqrt(var + eps) * sd[key + ".weight"]
    return (x - mean.view(shape)) * inv.view(shape) \
        + sd[key + ".bias"].view(shape)


@contextlib.contextmanager
def global_statistics():
    """Within it ``nets``' training BatchNorm is ``global_batch_norm``."""
    local = nets.batch_norm_batch
    nets.batch_norm_batch = global_batch_norm
    try:
        yield
    finally:
        nets.batch_norm_batch = local


def forward(img, sd, cfg, p, step):
    with global_statistics():
        return nets.segtran3d(img, sd, cfg, p, train=True)


def average(grads, loss):
    """The gradients and the loss averaged over the ranks (one
    all-reduce of the flattened gradients)."""
    n = dist.get_world_size()
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names] + [loss.reshape(1)])
    dist.all_reduce(flat)
    flat /= n
    out, off = {}, 0
    for k in names:
        out[k] = flat[off:off + grads[k].numel()].view_as(grads[k])
        off += grads[k].numel()
    return out, flat[-1]


def Trainer(params, buffers, cfg, train, p=nets.FP32):
    """This rank's share of the data-parallel reference step."""
    return steps.Trainer(params, buffers, cfg, train, forward, p, average)
